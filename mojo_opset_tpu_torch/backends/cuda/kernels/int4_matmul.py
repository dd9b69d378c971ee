"""Kernel G: packed-int4 x int8 -> int32 GEMM with the dequant epilogue
(``csrc/int4_matmul.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/int4_matmul.py:85``
(``int4_scaled_matmul``). ``launches`` counts kernel launches,
``launches_by_route`` the same launches by (route name, M). ``route``
picks the kernel's route from shapes alone: M > 16 on wgmma fed by TMA
(the packed tile unpacked in shared memory) with a 256- or 128-wide tile
and K split where one m tile leaves most SMs idle; M <= 16 on 8 packed
rows a block, 16-byte register loads and mma.sync tiles, 1-16 warps a
block, with K split where the blocks leave most SMs idle.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import int8_matmul
from mojo_opset_tpu_torch.core.operators.gemm import (
    INT4_BLOCK,
    QUANT_OUTPUT_DTYPES,
    quant_matmul_reference,
    unpack_int4_rows,
)

launches = 0
launches_by_route: Counter = Counter()  # (route name, M) -> launches

# route codes shared with csrc/int4_matmul.cu
DECODE, WGMMA_128, WGMMA_256 = 0, 1, 2
ROUTE_NAMES = {DECODE: "decode", WGMMA_128: "wgmma_128", WGMMA_256: "wgmma_256"}
DECODE_M = 16  # M <= DECODE_M takes a decode route
# the kernels sum 16 x the int4 products, each at most 2^14 in size, in int32 (csrc/int_wgmma.cuh kMaxPackedK)
MAX_K = (1 << 17) - 16
DECODE_CHANNELS = 16  # output channels a decode block owns: 8 packed rows, low and high nibbles
DECODE_STEP = 64  # bytes of K in a decode warp step; a split is a range of whole steps
DECODE_UNROLL, DECODE_MAX_WARPS = 4, 16  # steps a warp has in flight; warps a decode block
# a decode block takes as many warps as give each one run of DECODE_UNROLL steps, up to DECODE_MAX_WARPS, and no more
# than keep the grid to one wave of DECODE_WARPS_PER_SM warps an SM (the kernel's 56 registers a thread leave room
# for 36; benchmark/split_sweep.py int4: gate/up's 608 blocks took 0.0087 ms at 8 warps, past one wave, against
# 0.0056 at 6); K is split over blocks only where the N / 16 blocks would fill less than 1 / DECODE_SPLIT_SM_SHARE of
# the SMs (the sweep: at the draft's shapes, 64 blocks and more, the best split was never faster than none: 1.4x its
# time at k/v's 64)
DECODE_SPLIT_SM_SHARE, DECODE_WARPS_PER_SM = 4, 32
PREFILL_BM, PREFILL_BK = int8_matmul.PREFILL_BM, int8_matmul.PREFILL_BK
# split K at prefill only with one m tile (M <= 128) whose units fill at most half the SMs, into at most
# PREFILL_MAX_SPLITS ranges of at least PREFILL_MIN_SPLIT_TILES k-tiles (the sweep at M = 17: q, k/v and o fastest at
# 4 splits, 0.0101-0.0116 ms against 0.0124-0.0176 unsplit; at M = 512 every split was slower, k/v 0.0148 at 2
# against 0.0130 unsplit, as each split writes and rereads its int32 tile; at M = 130 only o gained, 6% at 2)
PREFILL_MIN_SPLIT_TILES, PREFILL_MAX_SPLITS = 4, 4


class Route(NamedTuple):
    code: int  # DECODE, WGMMA_128 or WGMMA_256
    splits: int  # K ranges (1: no split)
    warps: int = 0  # warps a decode block (0: the wgmma route's fixed block)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _whole_ranges(k_units: int, want: int) -> int:
    """The count of ranges of ``ceil(k_units / count)`` units nearest
    ``want`` from below: every range holds whole units and none is empty."""
    per = _cdiv(k_units, max(1, min(want, k_units)))
    return _cdiv(k_units, per)


def decode_splits(M: int, N: int, K: int, sms: int) -> int:
    """K ranges of a decode route: 1 where the N / 16 blocks fill
    1 / DECODE_SPLIT_SM_SHARE of the SMs, else as many as bring the grid
    there, each a range of whole 64-byte steps and none empty."""
    tiles = N // DECODE_CHANNELS
    want = _cdiv(sms // DECODE_SPLIT_SM_SHARE, tiles)
    k_steps = _cdiv(K, DECODE_STEP)
    if want <= 1 or k_steps < 2 or tiles > int8_matmul.ARRIVAL_SLOTS:
        return 1
    return _whole_ranges(k_steps, want)


def prefill_splits(M: int, N: int, K: int, bn: int, sms: int) -> int:
    """K ranges of the wgmma route: 1 unless M fills one m tile and its
    n-tile units fill at most half the SMs; then as many as bring the units
    to the SMs, at most PREFILL_MAX_SPLITS, each at least
    PREFILL_MIN_SPLIT_TILES 128-byte k-tiles, none empty."""
    tiles = _cdiv(N, bn)
    if M > PREFILL_BM or 2 * tiles > sms:
        return 1
    k_tiles = _cdiv(K, PREFILL_BK)
    return _whole_ranges(k_tiles, min(sms // tiles, PREFILL_MAX_SPLITS, k_tiles // PREFILL_MIN_SPLIT_TILES))


def decode_warps(N: int, K: int, splits: int, sms: int) -> int:
    """Warps a decode block: one run of DECODE_UNROLL steps each, up to
    DECODE_MAX_WARPS, and no more than keep the grid's warps to
    DECODE_WARPS_PER_SM an SM."""
    steps = _cdiv(_cdiv(K, DECODE_STEP), splits)
    wave = DECODE_WARPS_PER_SM * sms // (N // DECODE_CHANNELS * splits)
    return max(1, min(DECODE_MAX_WARPS, _cdiv(steps, DECODE_UNROLL), wave))


def route(M: int, N: int, K: int, sms: int) -> Route:
    """The kernel's route, from shapes alone."""
    if M <= DECODE_M:
        splits = decode_splits(M, N, K, sms)
        return Route(DECODE, splits, decode_warps(N, K, splits, sms))
    bn = int8_matmul.prefill_tile_n(M, N, sms)
    return Route(WGMMA_256 if bn == 256 else WGMMA_128, prefill_splits(M, N, K, bn, sms))


def split_scratch_ints(M: int, N: int, plan: Route) -> int:
    """int32 of a split launch's partial tiles: each split's tile of every
    output tile (decode: M x 16 a block; wgmma: 128 x BN a unit)."""
    if plan.splits == 1:
        return 0
    if plan.code == DECODE:
        return plan.splits * M * N
    bn = 256 if plan.code == WGMMA_256 else 128
    return plan.splits * _cdiv(M, PREFILL_BM) * PREFILL_BM * _cdiv(N, bn) * bn


def int4_scaled_matmul_plain(x, w_packed, input_scale, weight_scale, output_dtype):
    """Unpack, then the int8 golden (exact int32 sums, fp32 epilogue)."""
    return quant_matmul_reference(x, unpack_int4_rows(w_packed), input_scale, weight_scale, True, output_dtype)


def int4_scaled_matmul(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    input_scale: torch.Tensor,
    weight_scale: torch.Tensor,
    output_dtype: torch.dtype,
) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * W[n, k]) * input_scale[m] *
    weight_scale[n]`` for int8 x (M, K) and W unpacked from ``w_packed``,
    int8 (N // 2, K) in the ``pack_int4_rows`` layout; fp32 scales (M,) or
    (M, 1) and (N,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("int4_scaled_matmul", x, w_packed, input_scale, weight_scale)
    if x.device.type == "cpu":
        return int4_scaled_matmul_plain(x, w_packed, input_scale, weight_scale, output_dtype)
    return _int4_matmul_kernel(x, w_packed, input_scale, weight_scale, output_dtype)


def _int4_matmul_kernel(x, w_packed, input_scale, weight_scale, output_dtype):
    global launches
    build.require(output_dtype in QUANT_OUTPUT_DTYPES, f"output dtype must be one of {QUANT_OUTPUT_DTYPES}")
    build.require(x.ndim == 2 and w_packed.ndim == 2, "x and w_packed must be 2-D")
    M, K = x.shape
    N = w_packed.shape[0] * 2
    build.require(w_packed.shape[1] == K, f"w_packed {tuple(w_packed.shape)} does not match x {tuple(x.shape)}")
    build.require(N % INT4_BLOCK == 0, f"the int4 GEMM takes N % {INT4_BLOCK} == 0, got N = {N}")
    build.require(K % 16 == 0 and K <= MAX_K, f"the int4 GEMM takes K % 16 == 0 and K <= {MAX_K}, got K = {K}")
    build.require_device(x.device, w_packed, input_scale, weight_scale)
    for name, t in (("x", x), ("w_packed", w_packed)):
        build.require(
            t.dtype == torch.int8 and t.is_contiguous() and t.data_ptr() % 16 == 0,
            f"{name} must be contiguous 16-byte aligned int8, got {t.dtype}",
        )
    for name, t, n in (("input_scale", input_scale, M), ("weight_scale", weight_scale, N)):
        build.require(
            t.dtype == torch.float32 and t.numel() == n and t.is_contiguous(),
            f"{name} must be contiguous float32 with {n} values, got {t.dtype} {tuple(t.shape)}",
        )
    out = torch.empty((M, N), dtype=output_dtype, device=x.device)
    if M == 0 or K == 0:
        return out.zero_()
    plan = route(M, N, K, build.sm_count(x.device))
    part = arrivals = None
    if plan.splits > 1:
        part = torch.empty(split_scratch_ints(M, N, plan), dtype=torch.int32, device=x.device)
        arrivals = int8_matmul.arrival_counters(x.device)
    build.launch(
        "mojo_int4_matmul", x.device,
        x.data_ptr(), w_packed.data_ptr(), input_scale.data_ptr(), weight_scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if arrivals is None else arrivals.data_ptr(),
        M, N, K, plan.code, plan.splits, plan.warps, build.DTYPE_CODES[output_dtype],
    )
    launches += 1
    launches_by_route[ROUTE_NAMES[plan.code], M] += 1
    return out
