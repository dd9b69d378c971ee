"""Kernel D: varlen paged prefill GQA (``csrc/paged_prefill.cu``) and its
plain PyTorch version; with ``key_scale``/``value_scale``, kernel D' over
int8 (C8) pages.

Replaces the JAX package's ``backends/pallas/kernels/flash_prefill.py:358``
(``paged_prefill_gqa``) and, for int8 pages, the scale folding around it
(``backends/pallas/operators/attention.py:271-318``). ``launches`` counts
kernel launches. Groups over 64 query heads a kv head go in chunks of at
most 64 (a query tile holds 64 (token, head) rows; the kernel splits the
group itself); head_dims are ``paged_decode.takes_head_dim``'s, run at the
next instantiated width.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.paged_decode import (
    _int32_table,
    cache_strides,
    check_paged_cache,
    scale_pointers,
)
from mojo_opset_tpu_torch.core.operators.attention import paged_prefill_reference
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import paged_prefill_dequant_reference

launches = 0



def paged_prefill_gqa_plain(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_q_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    cu_total_seq_lens: Optional[torch.Tensor] = None,
    gqa_layout: str = "AABB",
    kv_layout: str = "HND",
    is_causal: bool = True,
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The golden of the same call: paged prefill, or with scales the
    KV-dequant prefill over int8 HND pages."""
    if key_scale is None:
        return paged_prefill_reference(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            gqa_layout, kv_layout, is_causal,
        )
    return paged_prefill_dequant_reference(
        query, key_cache, key_scale, value_cache, value_scale, cu_q_lens, block_tables, softmax_scale,
        cu_total_seq_lens, gqa_layout, is_causal, query.dtype,
    )


def paged_prefill_gqa(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    cu_q_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    cu_total_seq_lens: Optional[torch.Tensor] = None,
    gqa_layout: str = "AABB",
    kv_layout: str = "HND",
    *,
    is_causal: bool = True,
    max_q_len: Optional[int] = None,
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal varlen prefill: q (T, Hq, D) packed by ``cu_q_lens`` over the
    paged cache, kv lengths from ``cu_total_seq_lens`` (default: the q
    lengths); int8 caches take their (Hkv, D) ``key_scale`` and
    ``value_scale``. ``max_q_len`` (a host int) bounds the kernel's grid.

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("paged_prefill_gqa", query, key_cache, value_cache, key_scale, value_scale)
    if query.device.type == "cpu":
        return paged_prefill_gqa_plain(
            query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
            gqa_layout, kv_layout, is_causal, key_scale, value_scale,
        )
    return _prefill_kernel(
        query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
        gqa_layout, kv_layout, is_causal, max_q_len, key_scale, value_scale,
    )


def _prefill_kernel(query, key_cache, value_cache, cu_q_lens, block_tables, softmax_scale, cu_total_seq_lens,
                    gqa_layout, kv_layout, is_causal, max_q_len, key_scale, value_scale):
    global launches
    code = build.dtype_code(query)
    build.require(is_causal, "the prefill kernel is causal only")
    build.require(max_q_len is not None, "the prefill kernel needs max_q_len (a host int) for its grid")
    build.require(query.ndim == 3, f"query must be (T, Hq, D), got {tuple(query.shape)}")
    Hq, Hkv, bs, D = check_paged_cache(query, key_cache, value_cache, kv_layout, key_scale, value_scale)
    B = block_tables.shape[0]
    build.require_device(query.device, cu_q_lens, block_tables)
    _int32_table(cu_q_lens, "cu_q_lens", (B + 1,))
    _int32_table(block_tables, "block_tables", (B, block_tables.shape[1]))
    if cu_total_seq_lens is not None:
        build.require_device(query.device, cu_total_seq_lens)
        _int32_table(cu_total_seq_lens, "cu_total_seq_lens", (B + 1,))
    scale = 1.0 / math.sqrt(D) if softmax_scale is None else softmax_scale
    k_scale, v_scale, kv_int8 = scale_pointers(key_scale, value_scale)
    out = torch.empty_like(query)
    build.launch(
        "mojo_paged_prefill", query.device,
        query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(), k_scale, v_scale, cu_q_lens.data_ptr(),
        None if cu_total_seq_lens is None else cu_total_seq_lens.data_ptr(),
        block_tables.data_ptr(), out.data_ptr(),
        B, int(max_q_len), Hq, Hkv, D, bs, block_tables.shape[1], *cache_strides(key_cache, kv_layout),
        float(scale), int(gqa_layout == "ABAB"), kv_int8, code,
    )
    launches += 1
    return out
