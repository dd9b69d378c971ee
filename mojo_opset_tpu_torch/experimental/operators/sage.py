"""Sage paged prefill attention: int8 Q and K with fine-grained scales
(counterpart of the JAX package's ``experimental/operators/sage.py``:
``MojoPagedPrefillSageGQA`` :27).

Q is quantized per (head, token) with scale ``(Hq, T)``, K per (block,
head, position) with scale ``(N_blocks, Hkv, bs)``, V per channel ``(Hkv,
D)``. The unnormalized ``exp`` scores are rounded to integer levels of
1/127 (``torch.round``: half to even, as ``jnp.round``) before the PV
product and the denominator, and the output is bf16. The golden walks the
sequences one at a time, as the paged prefill golden does, where the JAX
golden gathers every sequence's keys for every token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.attention import (
    GQA_LAYOUTS,
    assert_paged_prefill_contract,
    expand_gqa,
    prefill_sequences,
)

Q_MAX = 127.0


class MojoPagedPrefillSageGQA(MojoOperator):
    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB", query_dtype=torch.int8,
                 context_dtype=torch.int8, compute_dtype=torch.int8):
        super().__init__()
        if gqa_layout not in GQA_LAYOUTS:
            raise ValueError(f"gqa_layout must be one of {GQA_LAYOUTS}, got {gqa_layout}")
        if not query_dtype == context_dtype == compute_dtype == torch.int8:
            raise ValueError("Sage attention takes int8 query, context and compute dtypes only")
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.query_dtype = query_dtype
        self.context_dtype = context_dtype
        self.compute_dtype = compute_dtype

    def forward(
        self,
        query: torch.Tensor,  # (T, Hq, D) int8
        query_scale: torch.Tensor,  # (Hq, T) fp32
        key_cache: torch.Tensor,  # (N, Hkv, bs, D) int8
        key_scale: torch.Tensor,  # (N, Hkv, bs) fp32
        value_cache: torch.Tensor,  # (N, Hkv, bs, D) int8
        value_scale: torch.Tensor,  # (Hkv, D) fp32
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        """(T, Hq, D) bf16; a non-causal call reads ``mask`` with the
        prefill contract (rows ``q_abs``, True = keep)."""
        assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
        T, Hq, D = query.shape
        N, Hkv, bs, _ = key_cache.shape
        if query_scale.shape != (Hq, T) or key_scale.shape != (N, Hkv, bs) or value_scale.shape != (Hkv, D):
            raise ValueError(f"scales must be ({Hq}, {T}), ({N}, {Hkv}, {bs}) and ({Hkv}, {D}), got "
                             f"{tuple(query_scale.shape)}, {tuple(key_scale.shape)}, {tuple(value_scale.shape)}")
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        group = Hq // Hkv
        q_sc = query_scale.float().t()  # (T, Hq)
        v_sc = expand_gqa(value_scale.float(), group, self.gqa_layout, 0)  # (Hq, D)
        mask = mask if not self.is_causal else None
        # the key scales walk the pages beside the keys: an HND "cache" one lane wide
        ks_cache = key_scale.float()[..., None]
        out = torch.zeros((T, Hq, D), dtype=torch.bfloat16, device=query.device)
        walks = zip(
            prefill_sequences(key_cache, value_cache, cu_q_lens, block_tables, cu_total_seq_lens, "HND",
                              self.is_causal, mask),
            prefill_sequences(ks_cache, ks_cache, cu_q_lens, block_tables, cu_total_seq_lens, "HND",
                              self.is_causal, mask),
        )
        for (q0, q1, k, v, keep), (_, _, ks, _, _) in walks:
            k = expand_gqa(k, group, self.gqa_layout, 1)  # (K, Hq, D)
            v = expand_gqa(v, group, self.gqa_layout, 1)
            ks = expand_gqa(ks[..., 0], group, self.gqa_layout, 1)  # (K, Hq)
            scores = torch.einsum("qhd,khd->qhk", query[q0:q1].float(), k.float()) * softmax_scale
            scores = scores * q_sc[q0:q1, :, None] * ks.t()[None]
            scores = scores.masked_fill(~keep[:, None, :], float("-inf"))
            m = scores.amax(dim=-1, keepdim=True)
            m = torch.where(torch.isneginf(m), 0.0, m)
            p_quant = torch.round(torch.exp(scores - m) * Q_MAX)
            denom = p_quant.sum(dim=-1, keepdim=True) * (1.0 / Q_MAX)
            o = torch.einsum("qhk,khd->qhd", p_quant, v.float())
            o = o * v_sc[None] * (1.0 / Q_MAX) / denom.clamp(min=1e-38)
            out[q0:q1] = o.to(torch.bfloat16)
        return out

    def extra_repr(self) -> str:
        return (f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, query_dtype={self.query_dtype}, "
                f"context_dtype={self.context_dtype}, compute_dtype={self.compute_dtype}")
