"""Kernel F: int8 x int8 -> int32 GEMM with the dequant epilogue
(``csrc/int8_matmul.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/int8_matmul.py:54``
(``int8_scaled_matmul``). ``launches`` counts kernel launches. ``route``
picks the kernel's route from shapes and the layout alone: the prefill
route (M > 16, an (N, K) weight) on wgmma fed by TMA with a 256- or
128-wide tile, the decode route (M <= 16) on mma.sync tiles with K split
where the output tiles alone would leave SMs idle, and a (K, N) weight at
M > 16 on mma.sync tiles.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.gemm import QUANT_OUTPUT_DTYPES
from mojo_opset_tpu_torch.core.operators.gemm import quant_matmul_reference as int8_scaled_matmul_plain

launches = 0

# route codes shared with csrc/int8_matmul.cu
LARGE_MMA, DECODE_MMA, WGMMA_128, WGMMA_256 = 0, 1, 2, 3
DECODE_M = 16  # rows of the decode tile: M <= DECODE_M takes the decode route
DECODE_BN, DECODE_BK = 32, 128  # the decode tile's columns and k-tile depth
PREFILL_BM, PREFILL_BK = 128, 128  # the wgmma tile's rows and the bytes of K a stage
# split K at decode until the grid holds this many blocks an SM (the fastest count or within 4% of it at every
# decode shape of benchmark/split_sweep.py's int8 sweep; 2 left 8-13% at some)
DECODE_BLOCKS_PER_SM = 4
# one arrival counter an output tile of a split launch, zeroed once a stream; the kernel returns each to 0
ARRIVAL_SLOTS = 1 << 16

_arrivals: dict = {}


class Route(NamedTuple):
    code: int  # LARGE_MMA, DECODE_MMA, WGMMA_128 or WGMMA_256
    splits: int  # K ranges of the decode route (1: no split)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prefill_tile_n(M: int, N: int, sms: int) -> int:
    """The wgmma tile's width: 256, or 128 where the 256-wide units would
    take more of the card's time. A persistent grid runs ceil(units / sms)
    rounds of units whose time grows with their width; 128 wins only where
    it takes fewer rounds x width (N = 1024 at M = 1650: 52 units of 256
    fill 52 of 132 SMs, 104 of 128 fill 104)."""
    m_tiles = _cdiv(M, PREFILL_BM)
    cost = {bn: _cdiv(m_tiles * _cdiv(N, bn), sms) * bn for bn in (256, 128)}
    return 128 if cost[128] < cost[256] else 256


def decode_splits(M: int, N: int, K: int, sms: int) -> int:
    """K ranges of the decode route: 1 where the (M / 16) x (N / 32) output
    tiles give DECODE_BLOCKS_PER_SM blocks an SM, else as many as bring the
    grid there, each range of whole 128-deep k-tiles and none empty."""
    tiles = _cdiv(M, DECODE_M) * _cdiv(N, DECODE_BN)
    k_tiles = _cdiv(K, DECODE_BK)
    want = _cdiv(DECODE_BLOCKS_PER_SM * sms, tiles)
    if want <= 1 or k_tiles < 2 or tiles > ARRIVAL_SLOTS:
        return 1
    per = _cdiv(k_tiles, min(want, k_tiles))
    return _cdiv(k_tiles, per)


def route(M: int, N: int, K: int, trans_weight: bool, sms: int) -> Route:
    """The kernel's route, from shapes and the layout alone."""
    if M <= DECODE_M:
        return Route(DECODE_MMA, decode_splits(M, N, K, sms))
    if trans_weight and K > 0:
        return Route(WGMMA_256 if prefill_tile_n(M, N, sms) == 256 else WGMMA_128, 1)
    return Route(LARGE_MMA, 1)


def split_scratch_ints(M: int, N: int, splits: int) -> int:
    """int32 of a split launch's partial tiles: each split's 16 x 32 tile of
    every output tile."""
    return splits * _cdiv(M, DECODE_M) * _cdiv(N, DECODE_BN) * DECODE_M * DECODE_BN


def arrival_counters(device: torch.device) -> torch.Tensor:
    """The zeroed counters of split launches on ``device``'s current stream
    (one buffer a stream, so launches on two streams never share one)."""
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else 0
    key = (device, stream)
    if key not in _arrivals:
        _arrivals[key] = torch.zeros(ARRIVAL_SLOTS, dtype=torch.int32, device=device)
    return _arrivals[key]


def int8_scaled_matmul(
    x: torch.Tensor,
    weight: torch.Tensor,
    input_scale: torch.Tensor,
    weight_scale: torch.Tensor,
    trans_weight: bool,
    output_dtype: torch.dtype,
) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * w[k, n]) * input_scale[m] *
    weight_scale[n]`` for int8 x (M, K) and w (K, N), or (N, K) with
    ``trans_weight``; fp32 scales (M,) or (M, 1) and (N,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("int8_scaled_matmul", x, weight, input_scale, weight_scale)
    if x.device.type == "cpu":
        return int8_scaled_matmul_plain(x, weight, input_scale, weight_scale, trans_weight, output_dtype)
    return _int8_matmul_kernel(x, weight, input_scale, weight_scale, trans_weight, output_dtype)


def _int8_matmul_kernel(x, weight, input_scale, weight_scale, trans_weight, output_dtype):
    global launches
    build.require(output_dtype in QUANT_OUTPUT_DTYPES, f"output dtype must be one of {QUANT_OUTPUT_DTYPES}")
    build.require(x.ndim == 2 and weight.ndim == 2, "x and weight must be 2-D")
    M, K = x.shape
    N = weight.shape[0] if trans_weight else weight.shape[1]
    build.require(
        tuple(weight.shape) == ((N, K) if trans_weight else (K, N)),
        f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)} (trans_weight={trans_weight})",
    )
    build.require(K % 16 == 0, f"the int8 GEMM takes K % 16 == 0, got K = {K}")
    build.require(trans_weight or N % 16 == 0, f"a (K, N) weight needs N % 16 == 0, got N = {N}")
    build.require_device(x.device, weight, input_scale, weight_scale)
    for name, t in (("x", x), ("weight", weight)):
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
    plan = route(M, N, K, trans_weight, build.sm_count(x.device))
    part = arrivals = None
    if plan.splits > 1:
        part = torch.empty(split_scratch_ints(M, N, plan.splits), dtype=torch.int32, device=x.device)
        arrivals = arrival_counters(x.device)
    build.launch(
        "mojo_int8_matmul", x.device,
        x.data_ptr(), weight.data_ptr(), input_scale.data_ptr(), weight_scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), None if arrivals is None else arrivals.data_ptr(),
        M, N, K, int(trans_weight), plan.code, plan.splits, build.DTYPE_CODES[output_dtype],
    )
    launches += 1
    return out
