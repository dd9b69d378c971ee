"""DeepSeek Multi-head Latent Attention (MLA) ops: the golden tier.

Counterpart of the JAX package's ``experimental/operators/mla.py``
(``attention_probs_with_optional_sink`` :36, ``_MLAConfigMixin`` :54,
``gather_paged_flat`` :92, ``MojoDecodeMLA`` :100, ``MojoPagedDecodeMLA``
:138, ``MojoPrefillMLA`` :183, ``MojoPagedPrefillMLA`` :236).

The KV cache holds the compressed latent ``c_kv`` (``kv_lora_rank``, r)
and the positional key ``k_pe`` (``qk_rope_head_dim``, dr); the op
decompresses the latents through the ``kv_b_proj`` weight it owns (fp32
``(H * (dn + dv), r)``, as in JAX). Paged caches are ``(N_blocks, 1,
block_size, dim)``. The goldens gather every cached position and
decompress it, as the JAX goldens do; the paged prefill golden's per-token
gather is ``T * K * H * (dn + dr)`` elements, so it serves small shapes
only. The ``cuda`` tier (``backends/cuda/operators/mla.py``) computes the
same in the absorbed latent space.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.attention import (
    assert_paged_decode_contract,
    assert_paged_prefill_contract,
    seq_lens_from_cu,
)

NEG_INF = float("-inf")


def attention_probs_with_optional_sink(scores: torch.Tensor, output_dtype, attn_sink: Optional[torch.Tensor]):
    """fp32 softmax over the last axis with an optional per-head sink
    column appended and then dropped (heads on axis -2); fully masked rows
    give zeros."""
    scores = scores.float()
    if attn_sink is not None:
        sink_shape = [1] * scores.ndim
        sink_shape[-2] = attn_sink.shape[0]
        sink = attn_sink.float().reshape(sink_shape).expand(*scores.shape[:-1], 1)
        probs = torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :-1]
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.nan_to_num(probs, nan=0.0).to(output_dtype)


class _MLAConfigMixin:
    def _init_mla(self, num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank, use_attn_sink,
                  device):
        self.num_heads = num_heads
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.kv_lora_rank = kv_lora_rank
        self.qk_head_dim = qk_nope_head_dim + qk_rope_head_dim
        self.use_attn_sink = use_attn_sink
        self.kv_b_proj = nn.Parameter(
            torch.empty((num_heads * (qk_nope_head_dim + v_head_dim), kv_lora_rank), device=device),
            requires_grad=False)
        self.attn_sink = (nn.Parameter(torch.zeros((num_heads,), device=device), requires_grad=False)
                          if use_attn_sink else None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """kv_b_proj from U(+-1/sqrt(r)), as the JAX op draws it; the sink
        stays zero."""
        bound = 1.0 / math.sqrt(self.kv_lora_rank)
        self.kv_b_proj.uniform_(-bound, bound, generator=generator)

    def _scale(self, softmax_scale: Optional[float]) -> float:
        return 1.0 / math.sqrt(self.qk_head_dim) if softmax_scale is None else softmax_scale

    def _decompress(self, c_kv: torch.Tensor):
        """c_kv (..., r) -> k_nope (..., H, dn), v (..., H, dv), in c_kv's dtype."""
        kv = torch.matmul(c_kv.float(), self.kv_b_proj.float().t()).to(c_kv.dtype)
        kv = kv.reshape(*c_kv.shape[:-1], self.num_heads, self.qk_nope_head_dim + self.v_head_dim)
        return kv[..., : self.qk_nope_head_dim], kv[..., self.qk_nope_head_dim:]

    def extra_repr(self) -> str:
        return (
            f"num_heads={self.num_heads}, qk_nope_head_dim={self.qk_nope_head_dim}, "
            f"qk_rope_head_dim={self.qk_rope_head_dim}, v_head_dim={self.v_head_dim}, "
            f"kv_lora_rank={self.kv_lora_rank}, use_attn_sink={self.use_attn_sink}"
        )


def gather_paged_flat(cache: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(N, 1, bs, D) + (B, NB) -> (B, NB * bs, D), invalid ids clamped."""
    g = cache[block_tables.clamp(0, cache.shape[0] - 1).long()][:, :, 0]  # (B, NB, bs, D)
    B, NB, bs, D = g.shape
    return g.reshape(B, NB * bs, D)


def _token_batch(cu_q_lens: torch.Tensor, T: int, B: int):
    """Each packed token's sequence and its position in that sequence."""
    token_ids = torch.arange(T, dtype=torch.int32, device=cu_q_lens.device)
    batch = (torch.searchsorted(cu_q_lens, token_ids, right=True) - 1).clamp(0, B - 1)
    return batch, token_ids - cu_q_lens[batch]


class MojoDecodeMLA(_MLAConfigMixin, MojoOperator):
    """Non-paged MLA decode: q (B, H, dqk), c_kv (B, S, r), k_pe (B, S, 1, dr)."""

    def __init__(self, num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank,
                 use_attn_sink: bool = False, *, device=None):
        super().__init__()
        self._init_mla(num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank, use_attn_sink,
                       device)

    def forward(self, query, compressed_kv, k_pe, total_seq_lens=None, softmax_scale=None):
        B, H, _ = query.shape
        S = compressed_kv.shape[1]
        k_nope, v = self._decompress(compressed_kv)  # (B, S, H, *)
        k = torch.cat([k_nope, k_pe.expand(B, S, H, self.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
        scores = torch.einsum("bhd,bshd->bhs", query.float(), k.float()) * self._scale(softmax_scale)
        if total_seq_lens is not None:
            mask = torch.arange(S, device=query.device)[None, None, :] < total_seq_lens[:, None, None]
            scores = scores.masked_fill(~mask, NEG_INF)
        probs = attention_probs_with_optional_sink(scores, query.dtype, self.attn_sink)
        return torch.einsum("bhs,bshd->bhd", probs, v.to(query.dtype)).to(query.dtype)


class MojoPagedDecodeMLA(_MLAConfigMixin, MojoOperator):
    """Paged MLA decode over latent block caches: q (B, H, dn + dr),
    caches (N, 1, bs, r) and (N, 1, bs, dr); ``total_seq_lens`` count the
    new token. A zero-length sequence gives zeros."""

    def __init__(self, num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank,
                 use_attn_sink: bool = False, *, device=None):
        super().__init__()
        self._init_mla(num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank, use_attn_sink,
                       device)

    def forward(self, query, compressed_kv_cache, k_pe_cache, total_seq_lens, block_tables, softmax_scale=None):
        assert_paged_decode_contract(block_tables, total_seq_lens)
        B, H, _ = query.shape
        c_kv = gather_paged_flat(compressed_kv_cache, block_tables)  # (B, K, r)
        k_pe = gather_paged_flat(k_pe_cache, block_tables)[..., : self.qk_rope_head_dim]
        K = c_kv.shape[1]
        k_nope, v = self._decompress(c_kv)  # (B, K, H, *)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(B, K, H, self.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
        scores = torch.einsum("bhd,bshd->bhs", query.float(), k.float()) * self._scale(softmax_scale)
        mask = torch.arange(K, device=query.device)[None, None, :] < total_seq_lens[:, None, None]
        probs = attention_probs_with_optional_sink(scores.masked_fill(~mask, NEG_INF), query.dtype, self.attn_sink)
        out = torch.einsum("bhs,bshd->bhd", probs, v.to(query.dtype))
        return torch.where((total_seq_lens > 0)[:, None, None], out, 0).to(query.dtype)


class MojoPrefillMLA(_MLAConfigMixin, MojoOperator):
    """Varlen MLA prefill: q (T, H, dqk), c_kv (T, r), k_pe (T, 1, dr)."""

    def __init__(self, num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank,
                 is_causal: bool = True, use_attn_sink: bool = False, *, device=None):
        super().__init__()
        self._init_mla(num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank, use_attn_sink,
                       device)
        self.is_causal = is_causal

    def forward(self, query, compressed_kv, k_pe, cu_q_lens, softmax_scale=None):
        if cu_q_lens.dtype != torch.int32:
            raise ValueError(f"cu_q_lens must be int32, got {cu_q_lens.dtype}")
        T, H, _ = query.shape
        k_nope, v_all = self._decompress(compressed_kv)  # (T, H, *)
        k_all = torch.cat([k_nope, k_pe.expand(T, H, self.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)
        batch, pos = _token_batch(cu_q_lens, T, cu_q_lens.shape[0] - 1)
        scores = torch.einsum("thd,shd->ths", query.float(), k_all.float()) * self._scale(softmax_scale)
        keep = batch[:, None] == batch[None, :]
        if self.is_causal:
            keep = keep & (pos[:, None] >= pos[None, :])
        probs = attention_probs_with_optional_sink(scores.masked_fill(~keep[:, None, :], NEG_INF), query.dtype,
                                                   self.attn_sink)
        return torch.einsum("ths,shd->thd", probs, v_all.to(query.dtype)).to(query.dtype)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", is_causal={self.is_causal}"


class MojoPagedPrefillMLA(_MLAConfigMixin, MojoOperator):
    """Paged MLA prefill over latent block caches; chunked prefill through
    ``cu_total_seq_lens`` (query row i of sequence b sits at position
    ``kv_len[b] - q_len[b] + i``)."""

    def __init__(self, num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank,
                 is_causal: bool = True, use_attn_sink: bool = False, *, device=None):
        super().__init__()
        self._init_mla(num_heads, qk_nope_head_dim, qk_rope_head_dim, v_head_dim, kv_lora_rank, use_attn_sink,
                       device)
        self.is_causal = is_causal

    def forward(self, query, compressed_kv_cache, k_pe_cache, cu_q_lens, block_tables, softmax_scale=None,
                cu_total_seq_lens=None):
        assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
        T, H, _ = query.shape
        q_lens = seq_lens_from_cu(cu_q_lens)
        kv_lens = q_lens if cu_total_seq_lens is None else seq_lens_from_cu(cu_total_seq_lens)
        B = q_lens.shape[0]

        c_kv = gather_paged_flat(compressed_kv_cache, block_tables)  # (B, K, r)
        k_pe = gather_paged_flat(k_pe_cache, block_tables)[..., : self.qk_rope_head_dim]
        K = c_kv.shape[1]
        k_nope, v = self._decompress(c_kv)
        k = torch.cat([k_nope, k_pe[:, :, None].expand(B, K, H, self.qk_rope_head_dim).to(k_nope.dtype)], dim=-1)

        batch, q_pos = _token_batch(cu_q_lens, T, B)
        kv_len_t = kv_lens[batch]
        q_abs = kv_len_t - q_lens[batch] + q_pos
        k_t, v_t = k[batch.long()], v[batch.long()]  # (T, K, H, *): the golden's per-token gather
        scores = torch.einsum("thd,tshd->ths", query.float(), k_t.float()) * self._scale(softmax_scale)
        kv_pos = torch.arange(K, dtype=torch.int32, device=query.device)[None, :]
        keep = kv_pos < kv_len_t[:, None]
        if self.is_causal:
            keep = keep & (kv_pos <= q_abs[:, None])
        probs = attention_probs_with_optional_sink(scores.masked_fill(~keep[:, None, :], NEG_INF), query.dtype,
                                                   self.attn_sink)
        out = torch.einsum("ths,tshd->thd", probs, v_t.to(query.dtype))
        return torch.where((kv_len_t > 0)[:, None, None], out, 0).to(query.dtype)

    def extra_repr(self) -> str:
        return super().extra_repr() + f", is_causal={self.is_causal}"
