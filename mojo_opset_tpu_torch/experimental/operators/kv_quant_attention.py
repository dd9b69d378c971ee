"""Paged GQA attention over int8 (C8) KV caches, dequant fused in.

Counterpart of the JAX package's
``experimental/operators/kv_quant_attention.py`` (``dynamic_quantize``
:36, ``_KVDequantConfig`` :45, ``MojoPagedDecodeGQAWithKVDequant`` :109,
``MojoPagedPrefillGQAWithKVDequant`` :169, ``_SWADequantMixin`` :231,
``MojoPagedDecodeSWAWithKVDequant`` :243, ``MojoPagedPrefillSWAWithKVDequant``
:283, ``MojoPagedDecodeNstepSWA`` :336). The caches are int8 HND with
per-channel fp32 scales ``(Hkv, D)``; the golden dequantizes K and V in
fp32. ``compute_dtype=torch.int8`` re-quantizes the key-scaled query and
the probabilities per row, so both products run on int8 values (golden
tier only). A non-causal call reads a custom ``mask`` with the contracts of
``core/operators/attention.py`` (decode: row ``total_seq_len``, True =
exclude; prefill: rows ``q_abs``, True = keep; JAX :121, :180). The n-step
decode reads bf16/fp32 pages, not int8 ones: it is the speculative
verify's windowed decode of S rows a sequence.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.attention import (
    GQA_LAYOUTS,
    assert_paged_decode_contract,
    assert_paged_prefill_contract,
    decode_keep_mask,
    expand_gqa,
    gather_paged_kv,
    masked_softmax,
    prefill_sequences,
    window_mask_rows,
)
from mojo_opset_tpu_torch.core.operators.quantize import dynamic_quant

Q_MAX, Q_MIN = 127.0, -128.0


def dynamic_quantize(tensor: torch.Tensor, qmax: float = Q_MAX, qmin: float = Q_MIN, quant_dtype=torch.int8):
    """Per-last-dim symmetric dynamic quant; returns ``(q, scale (..., 1))``."""
    if quant_dtype != torch.int8:
        raise NotImplementedError(f"Unsupported quant_dtype: {quant_dtype}, expected torch.int8")
    return dynamic_quant(tensor, qmax, qmin)


def _scores(eq, q, k, key_scale, softmax_scale, int8_compute):
    """q (..., Hq, D) fp; k (..., K, Hq, D) int8; key_scale (Hq, D)."""
    if int8_compute:
        q_quant, q_scale = dynamic_quantize(q.float() * key_scale.float())
        return torch.einsum(eq, q_quant.float(), k.float()) * q_scale * softmax_scale
    return torch.einsum(eq, q.float(), k.float() * key_scale.float()) * softmax_scale


def _pv(eq, probs, v, value_scale, int8_compute):
    """probs (..., Hq, K); v (..., K, Hq, D) int8; value_scale (Hq, D)."""
    if int8_compute:
        p_quant, p_scale = dynamic_quantize(probs.float())
        return torch.einsum(eq, p_quant.float(), v.float()) * p_scale * value_scale.float()
    return torch.einsum(eq, probs.float(), v.float() * value_scale.float())


def _expand_scales(key_scale, value_scale, num_q_heads, num_kv_heads, gqa_layout):
    group = num_q_heads // num_kv_heads
    return expand_gqa(key_scale, group, gqa_layout, 0), expand_gqa(value_scale, group, gqa_layout, 0)


def paged_decode_dequant_reference(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    key_scale: torch.Tensor,
    value_cache: torch.Tensor,
    value_scale: torch.Tensor,
    total_seq_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    gqa_layout: str = "AABB",
    compute_dtype: Optional[torch.dtype] = None,
    local_window_size: Optional[int] = None,
    global_window_size: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Golden decode over int8 HND pages: q (B, Hq, D) against the first
    ``total_seq_lens[b]`` tokens, K and V dequantized by their scales; with
    a window or a custom mask, the keys ``decode_keep_mask`` keeps."""
    assert_paged_decode_contract(block_tables, total_seq_lens)
    B, Hq, D = query.shape
    Hkv = key_cache.shape[1]
    group = Hq // Hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(D)
    int8_compute = compute_dtype == torch.int8
    ks, vs = _expand_scales(key_scale, value_scale, Hq, Hkv, gqa_layout)
    k = expand_gqa(gather_paged_kv(key_cache, block_tables), group, gqa_layout, 2)  # (B, K, Hq, D)
    v = expand_gqa(gather_paged_kv(value_cache, block_tables), group, gqa_layout, 2)
    scores = _scores("bhd,bkhd->bhk", query, k, ks, softmax_scale, int8_compute)
    valid = decode_keep_mask(total_seq_lens, k.shape[1], local_window_size, global_window_size, mask)[:, None, :]
    probs = masked_softmax(scores, valid, query.dtype)
    out = _pv("bhk,bkhd->bhd", probs, v, vs, int8_compute)
    out = torch.where((total_seq_lens > 0)[:, None, None], out, 0)
    return out.to(query.dtype)


def paged_prefill_dequant_reference(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    key_scale: torch.Tensor,
    value_cache: torch.Tensor,
    value_scale: torch.Tensor,
    cu_q_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    cu_total_seq_lens: Optional[torch.Tensor] = None,
    gqa_layout: str = "AABB",
    is_causal: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    mask: Optional[torch.Tensor] = None,
    local_window_size: Optional[int] = None,
    global_window_size: Optional[int] = None,
) -> torch.Tensor:
    """Golden varlen prefill over int8 HND pages, one sequence at a time
    (``prefill_sequences``, which reads the mask and the windows); chunked
    prefill through ``cu_total_seq_lens``."""
    assert_paged_prefill_contract(cu_q_lens, block_tables, cu_total_seq_lens)
    T, Hq, D = query.shape
    Hkv = key_cache.shape[1]
    group = Hq // Hkv
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(D)
    int8_compute = compute_dtype == torch.int8
    ks, vs = _expand_scales(key_scale, value_scale, Hq, Hkv, gqa_layout)
    out = torch.zeros_like(query)
    for q0, q1, k, v, keep in prefill_sequences(
        key_cache, value_cache, cu_q_lens, block_tables, cu_total_seq_lens, "HND", is_causal, mask,
        local_window_size, global_window_size,
    ):
        k = expand_gqa(k, group, gqa_layout, 1)  # (K, Hq, D)
        v = expand_gqa(v, group, gqa_layout, 1)
        scores = _scores("qhd,khd->qhk", query[q0:q1], k, ks, softmax_scale, int8_compute)
        probs = masked_softmax(scores, keep[:, None, :], query.dtype)
        out[q0:q1] = _pv("qhk,khd->qhd", probs, v, vs, int8_compute).to(query.dtype)
    return out


class _KVDequantConfig:
    def _init_dequant(self, is_causal, gqa_layout, query_dtype, context_dtype, compute_dtype):
        if gqa_layout not in GQA_LAYOUTS:
            raise ValueError(f"gqa_layout must be one of {GQA_LAYOUTS}, got {gqa_layout}")
        if query_dtype == torch.int8:
            raise NotImplementedError("Quantized query is not implemented")
        if context_dtype != torch.int8:
            raise ValueError(f"Quant attention supports int8 context only, got {context_dtype}")
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.query_dtype = query_dtype
        self.context_dtype = context_dtype
        self.compute_dtype = compute_dtype

    @staticmethod
    def _check_query_scale(query_scale) -> None:
        if query_scale is not None:
            raise NotImplementedError("query_scale: a quantized query is not implemented")

    def extra_repr(self) -> str:
        return (
            f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, query_dtype={self.query_dtype}, "
            f"context_dtype={self.context_dtype}, compute_dtype={self.compute_dtype}"
        )


class MojoPagedDecodeGQAWithKVDequant(_KVDequantConfig, MojoOperator):
    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB", query_dtype=torch.bfloat16,
                 context_dtype=torch.int8, compute_dtype=torch.bfloat16):
        super().__init__()
        self._init_dequant(is_causal, gqa_layout, query_dtype, context_dtype, compute_dtype)

    def forward(
        self,
        query: torch.Tensor,  # (B, Hq, D)
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,  # (N, Hkv, bs, D) int8
        key_scale: torch.Tensor,  # (Hkv, D)
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        mask: Optional[torch.Tensor] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        self._check_query_scale(query_scale)
        return paged_decode_dequant_reference(
            query, key_cache, key_scale, value_cache, value_scale, total_seq_lens, block_tables,
            softmax_scale, self.gqa_layout, self.compute_dtype, mask=None if self.is_causal else mask,
        )


class _SWADequantMixin(_KVDequantConfig):
    def _init_swa(self, global_window_size, local_window_size):
        self.global_window_size = global_window_size
        self.local_window_size = local_window_size

    def extra_repr(self) -> str:
        return (
            super().extra_repr()
            + f", global_window_size={self.global_window_size}, local_window_size={self.local_window_size}"
        )


class MojoPagedDecodeSWAWithKVDequant(_SWADequantMixin, MojoOperator):
    """``MojoPagedDecodeGQAWithKVDequant`` with the sliding/global window of
    ``MojoPagedDecodeSWA`` (causal only; non-causal sees every key)."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB",
                 global_window_size: Optional[int] = None, local_window_size: Optional[int] = None,
                 query_dtype=torch.bfloat16, context_dtype=torch.int8, compute_dtype=torch.bfloat16):
        super().__init__()
        self._init_dequant(is_causal, gqa_layout, query_dtype, context_dtype, compute_dtype)
        self._init_swa(global_window_size, local_window_size)

    def forward(
        self,
        query: torch.Tensor,  # (B, Hq, D)
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,  # (N, Hkv, bs, D) int8
        key_scale: torch.Tensor,  # (Hkv, D)
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        self._check_query_scale(query_scale)
        windows = (self.local_window_size, self.global_window_size) if self.is_causal else (None, None)
        return paged_decode_dequant_reference(
            query, key_cache, key_scale, value_cache, value_scale, total_seq_lens, block_table,
            softmax_scale, self.gqa_layout, self.compute_dtype, *windows,
        )


class MojoPagedPrefillGQAWithKVDequant(_KVDequantConfig, MojoOperator):
    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB", query_dtype=torch.bfloat16,
                 context_dtype=torch.int8, compute_dtype=torch.bfloat16):
        super().__init__()
        self._init_dequant(is_causal, gqa_layout, query_dtype, context_dtype, compute_dtype)

    def forward(
        self,
        query: torch.Tensor,  # (T, Hq, D)
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_tables: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        self._check_query_scale(query_scale)
        return paged_prefill_dequant_reference(
            query, key_cache, key_scale, value_cache, value_scale, cu_q_lens, block_tables, softmax_scale,
            cu_total_seq_lens, self.gqa_layout, self.is_causal, self.compute_dtype, mask,
        )


class MojoPagedPrefillSWAWithKVDequant(_SWADequantMixin, MojoOperator):
    """``MojoPagedPrefillGQAWithKVDequant`` with the sliding/global window of
    ``MojoPagedPrefillSWA`` (causal only; non-causal sees every key)."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB",
                 global_window_size: Optional[int] = None, local_window_size: Optional[int] = None,
                 query_dtype=torch.bfloat16, context_dtype=torch.int8, compute_dtype=torch.bfloat16):
        super().__init__()
        self._init_dequant(is_causal, gqa_layout, query_dtype, context_dtype, compute_dtype)
        self._init_swa(global_window_size, local_window_size)

    def forward(
        self,
        query: torch.Tensor,  # (T, Hq, D)
        query_scale: Optional[torch.Tensor],
        key_cache: torch.Tensor,
        key_scale: torch.Tensor,
        value_cache: torch.Tensor,
        value_scale: torch.Tensor,
        cu_q_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        cu_total_seq_lens: Optional[torch.Tensor] = None,
        *,
        max_q_len: Optional[int] = None,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        self._check_query_scale(query_scale)
        return paged_prefill_dequant_reference(
            query, key_cache, key_scale, value_cache, value_scale, cu_q_lens, block_table, softmax_scale,
            cu_total_seq_lens, self.gqa_layout, self.is_causal, self.compute_dtype, None,
            self.local_window_size, self.global_window_size,
        )


class MojoPagedDecodeNstepSWA(MojoOperator):
    """Multi-token (speculative N-step) windowed decode over HND pages: q
    (B, S, Hq, D), row s of sequence b at absolute position
    ``total_seq_lens[b] - S + s``; causal rows see ``window_mask_rows`` of
    the sequence's first ``total_seq_lens[b]`` keys, non-causal rows all of
    them. A sequence with ``total_seq_lens == 0`` gives 0."""

    def __init__(self, is_causal: bool = True, gqa_layout: str = "AABB",
                 global_window_size: Optional[int] = None, local_window_size: Optional[int] = None):
        super().__init__()
        if gqa_layout not in GQA_LAYOUTS:
            raise ValueError(f"gqa_layout must be one of {GQA_LAYOUTS}, got {gqa_layout}")
        self.is_causal = is_causal
        self.gqa_layout = gqa_layout
        self.global_window_size = global_window_size
        self.local_window_size = local_window_size

    def forward(
        self,
        query: torch.Tensor,  # (B, S, Hq, D)
        key_cache: torch.Tensor,
        value_cache: torch.Tensor,
        total_seq_lens: torch.Tensor,
        block_table: torch.Tensor,
        softmax_scale: Optional[float] = None,
        *,
        max_total_seq_len: Optional[int] = None,
    ) -> torch.Tensor:
        assert_paged_decode_contract(block_table, total_seq_lens)
        if query.ndim != 4:
            raise ValueError(f"NstepSWA expects a 4-D query (B, S, Hq, D), got {tuple(query.shape)}")
        B, S, Hq, D = query.shape
        group = Hq // key_cache.shape[1]
        if softmax_scale is None:
            softmax_scale = 1.0 / math.sqrt(D)
        k = expand_gqa(gather_paged_kv(key_cache, block_table), group, self.gqa_layout, 2)  # (B, K, Hq, D)
        v = expand_gqa(gather_paged_kv(value_cache, block_table), group, self.gqa_layout, 2)
        K = k.shape[1]
        scores = torch.einsum("bshd,bkhd->bhsk", query.float(), k.float()) * softmax_scale
        kv_pos = torch.arange(K, dtype=torch.int32, device=query.device)
        keep = (kv_pos[None, None, :] < total_seq_lens[:, None, None]).expand(B, S, K)
        if self.is_causal:
            q_abs = total_seq_lens[:, None] - S + torch.arange(S, dtype=torch.int32, device=query.device)[None, :]
            keep = keep & window_mask_rows(q_abs, kv_pos[None, :], self.local_window_size, self.global_window_size)
        probs = masked_softmax(scores, keep[:, None], query.dtype)
        out = torch.einsum("bhsk,bkhd->bshd", probs, v.to(query.dtype))
        out = torch.where((total_seq_lens > 0)[:, None, None, None], out, 0)
        return out.to(query.dtype)

    def extra_repr(self) -> str:
        return (
            f"is_causal={self.is_causal}, gqa_layout={self.gqa_layout}, "
            f"global_window_size={self.global_window_size}, local_window_size={self.local_window_size}"
        )
