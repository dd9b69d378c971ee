"""Kernel C: paged decode GQA (``csrc/paged_decode.cu``) and its plain
PyTorch version; with ``key_scale``/``value_scale``, kernel C' over int8
(C8) pages.

Replaces the JAX package's ``backends/pallas/kernels/paged_decode.py:260``
(``paged_decode_gqa``, with its ``local_window``/``global_window``) and, for
int8 pages, the scale folding around it
(``backends/pallas/operators/attention.py:225-268``). A window makes the
kernel skip the pages and keys outside it, not mask them after reading.
The kernel splits each row's keys over ``split_count`` blocks, a number
that depends on shapes only, and merges the splits' partials in split
order (a second launch when there are several). ``launches`` counts
calls of the kernel. Any head_dim that is a multiple of 16 up to 256 runs
at the next of ``HEAD_DIMS`` (``padded_head_dim``), the extra columns
zero in shared memory and never stored; ``takes_head_dim`` says which, and
the ops send the others to the golden.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.attention import paged_cache_dims, paged_decode_reference
from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import paged_decode_dequant_reference

launches = 0

HEAD_DIMS = (64, 128, 256)  # the widths the kernels are instantiated at
KEYS_PER_STEP = 64  # a block's step over the kept keys (8 warps x 8 keys): the unit of the split ranges
HEADS_PER_BLOCK = 16  # query heads of one block for groups above 4; a group of 4 or fewer takes one block
BLOCKS_PER_SM = 2  # the splits aim at this many blocks a streaming multiprocessor
MAX_SPLITS = 1024  # the kernel's merge takes at most this many


def takes_head_dim(head_dim: int) -> bool:
    """Whether the paged kernels (C, C', D, D') take ``head_dim``: a
    multiple of 16 (a 16-byte chunk of int8 pages) up to the widest width."""
    return 0 < head_dim <= HEAD_DIMS[-1] and head_dim % 16 == 0


def padded_head_dim(head_dim: int) -> int:
    """The instantiated width a head_dim runs at: the next of ``HEAD_DIMS``."""
    return next(d for d in HEAD_DIMS if d >= head_dim)


def group_chunks(group: int) -> int:
    """Blocks that share one kv head's group of query heads."""
    return 1 if group <= 4 else -(-group // HEADS_PER_BLOCK)


def split_count(batch: int, kv_heads: int, group: int, table_keys: int, local_window: Optional[int] = None,
                global_window: Optional[int] = None, sms: int = build.H100_SMS) -> int:
    """Splits of each row's kept keys, from shapes alone (never a sequence
    length: reading one would sync the host with the card). A grid that
    fills one wave of ``BLOCKS_PER_SM`` blocks an SM takes one split;
    a smaller one as many as keep it within that wave, and at least two
    (a grid just over one wave of short blocks pays a second wave, measured
    in PERF.md); never more than one a 64-key step of the longest row the
    table and windows allow."""
    kept = table_keys
    if local_window is not None:
        kept = min(kept, local_window + 1 + (global_window or 0))
    elif global_window is not None:
        kept = min(kept, global_window)
    blocks = batch * kv_heads * group_chunks(group)
    wave = BLOCKS_PER_SM * sms
    if blocks >= wave:
        return 1
    return max(1, min(max(2, wave // blocks), -(-kept // KEYS_PER_STEP), MAX_SPLITS))



def cache_strides(cache: torch.Tensor, kv_layout: str) -> tuple[int, int, int]:
    """(page, token, head) element strides of a paged cache."""
    if kv_layout == "HND":
        return cache.stride(0), cache.stride(2), cache.stride(1)
    return cache.stride(0), cache.stride(1), cache.stride(2)


def check_paged_cache(query: torch.Tensor, key_cache: torch.Tensor, value_cache: torch.Tensor, kv_layout: str,
                      key_scale: Optional[torch.Tensor] = None, value_scale: Optional[torch.Tensor] = None):
    """Shared input contract of the two paged attention kernels: caches in
    the query's dtype, or int8 exactly when (Hkv, D) fp32 scales are given."""
    _, Hkv, bs, D = paged_cache_dims(key_cache, kv_layout)
    Hq = query.shape[1]
    build.require_device(query.device, key_cache, value_cache)
    build.require(takes_head_dim(D), f"paged attention kernels take a head_dim that is a multiple of 16 up to "
                                     f"{HEAD_DIMS[-1]}, got {D}")
    build.require(query.shape[-1] == D, f"query head_dim {query.shape[-1]} != cache head_dim {D}")
    build.require(Hq % Hkv == 0, f"query heads {Hq} must be a multiple of kv heads {Hkv}")
    int8 = key_scale is not None or value_scale is not None
    cache_dtype = torch.int8 if int8 else query.dtype
    build.require(
        key_cache.dtype == cache_dtype and value_cache.dtype == cache_dtype,
        f"query and caches must share one dtype, or the caches be int8 exactly when key_scale and "
        f"value_scale are given; got {query.dtype}, {key_cache.dtype}, {value_cache.dtype}, scales: {int8}",
    )
    if int8:
        build.require(key_scale is not None and value_scale is not None, "int8 caches need both scales")
        build.require_device(query.device, key_scale, value_scale)
        for scale in (key_scale, value_scale):
            build.require(
                scale.dtype == torch.float32 and tuple(scale.shape) == (Hkv, D) and scale.is_contiguous(),
                f"KV scales must be contiguous float32 ({Hkv}, {D}), got {scale.dtype} {tuple(scale.shape)}",
            )
    build.require(
        query.is_contiguous() and key_cache.is_contiguous() and value_cache.is_contiguous()
        and key_cache.shape == value_cache.shape,
        "query and caches must be contiguous, and the caches of one shape",
    )
    build.require(
        key_cache.data_ptr() % 16 == 0 and value_cache.data_ptr() % 16 == 0,
        "caches must be 16-byte aligned",
    )
    return Hq, Hkv, bs, D


def scale_pointers(key_scale: Optional[torch.Tensor], value_scale: Optional[torch.Tensor]):
    """(k_scale, v_scale, kv_int8) arguments of the C entry points."""
    if key_scale is None:
        return None, None, 0
    return key_scale.data_ptr(), value_scale.data_ptr(), 1


def _int32_table(t: torch.Tensor, name: str, shape) -> None:
    build.require(
        t.dtype == torch.int32 and t.is_contiguous() and tuple(t.shape) == tuple(shape),
        f"{name} must be contiguous int32 {tuple(shape)}, got {t.dtype} {tuple(t.shape)}",
    )


def paged_decode_gqa_plain(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    total_seq_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    gqa_layout: str = "AABB",
    kv_layout: str = "HND",
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None,
    local_window: Optional[int] = None,
    global_window: Optional[int] = None,
) -> torch.Tensor:
    """The golden of the same call: paged decode, or with scales the
    KV-dequant decode over int8 HND pages, with the same windows."""
    if key_scale is None:
        return paged_decode_reference(
            query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, gqa_layout, kv_layout,
            local_window, global_window,
        )
    return paged_decode_dequant_reference(
        query, key_cache, key_scale, value_cache, value_scale, total_seq_lens, block_tables, softmax_scale,
        gqa_layout, query.dtype, local_window, global_window,
    )


def paged_decode_gqa(
    query: torch.Tensor,
    key_cache: torch.Tensor,
    value_cache: torch.Tensor,
    total_seq_lens: torch.Tensor,
    block_tables: torch.Tensor,
    softmax_scale: Optional[float] = None,
    gqa_layout: str = "AABB",
    kv_layout: str = "HND",
    key_scale: Optional[torch.Tensor] = None,
    value_scale: Optional[torch.Tensor] = None,
    local_window: Optional[int] = None,
    global_window: Optional[int] = None,
) -> torch.Tensor:
    """q (B, Hq, D) attends over its sequence's first ``total_seq_lens[b]``
    cached tokens; int8 caches take their (Hkv, D) ``key_scale`` and
    ``value_scale``. With ``local_window`` the row keeps the positions
    ``[max(sl - 1 - local, 0), sl)``, plus ``[0, global_window)`` when that
    is set; with ``global_window`` alone, ``[0, min(global, sl))``. A CPU
    tensor takes the plain version; a CUDA tensor the kernel."""
    for name, win in (("local_window", local_window), ("global_window", global_window)):
        build.require(win is None or 0 <= win < 2**31, f"paged_decode_gqa: {name} must be None or in [0, 2**31), "
                                                      f"got {win}")
    args = (query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, gqa_layout, kv_layout,
            key_scale, value_scale, local_window, global_window)
    build.require_no_grad("paged_decode_gqa", *args)
    if query.device.type == "cpu":
        return paged_decode_gqa_plain(*args)
    return _decode_kernel(*args)


def _decode_kernel(query, key_cache, value_cache, total_seq_lens, block_tables, softmax_scale, gqa_layout,
                   kv_layout, key_scale, value_scale, local_window, global_window):
    global launches
    code = build.dtype_code(query)
    build.require(query.ndim == 3, f"query must be (B, Hq, D), got {tuple(query.shape)}")
    Hq, Hkv, bs, D = check_paged_cache(query, key_cache, value_cache, kv_layout, key_scale, value_scale)
    B = query.shape[0]
    build.require_device(query.device, total_seq_lens, block_tables)
    _int32_table(total_seq_lens, "total_seq_lens", (B,))
    _int32_table(block_tables, "block_tables", (B, block_tables.shape[1]))
    scale = 1.0 / math.sqrt(D) if softmax_scale is None else softmax_scale
    k_scale, v_scale, kv_int8 = scale_pointers(key_scale, value_scale)
    splits = split_count(B, Hkv, Hq // Hkv, block_tables.shape[1] * bs, local_window, global_window,
                         build.sm_count(query.device))
    out = torch.empty_like(query)
    # per split and query head: acc (the padded width), max, sum; held until the launch is queued
    width = padded_head_dim(D) + 2
    partial = torch.empty(B, Hq, splits, width, dtype=torch.float32, device=query.device) if splits > 1 else None
    partial_ptr = None if partial is None else partial.data_ptr()
    build.launch(
        "mojo_paged_decode", query.device,
        query.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(), k_scale, v_scale,
        total_seq_lens.data_ptr(), block_tables.data_ptr(), out.data_ptr(), partial_ptr,
        B, Hq, Hkv, D, bs, block_tables.shape[1], *cache_strides(key_cache, kv_layout), splits,
        float(scale), int(gqa_layout == "ABAB"), -1 if local_window is None else local_window,
        -1 if global_window is None else global_window, kv_int8, code,
    )
    launches += 1
    return out
