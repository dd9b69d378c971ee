"""Kernel R: int8 / packed-int4 grouped scaled GEMM (``csrc/group_quant_gemm.cu``)
and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package computes the quantized experts'
products with XLA's ``ragged_dot`` on int8 with int32 sums
(``backends/xla/operators/moe.py:51``, ``XlaQuantExperts._ragged_quant_linear``).
``launches`` counts the wrapper's launches, ``launches_by_route`` the same
by route. The counts stay on the device: the decode tile's blocks find
their group from them, the prefill route's first launch writes the row
tiles into a scratch buffer (kernel H's row tiles), so a launch never
waits for the host.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.int4_matmul import MAX_K
from mojo_opset_tpu_torch.core.operators.gemm import QUANT_OUTPUT_DTYPES
from mojo_opset_tpu_torch.core.operators.moe import grouped_quant_matmul_reference as grouped_quant_matmul_plain

launches = 0
launches_by_route: dict = {}

# route codes shared with csrc/group_quant_gemm.cu, and each route's output tile (rows, columns)
DECODE, WGMMA, WGMMA_WIDE = 0, 1, 2
TILES = {DECODE: (16, 32), WGMMA: (128, 128), WGMMA_WIDE: (128, 256)}
ROUTE_NAMES = {DECODE: "decode", WGMMA: "wgmma", WGMMA_WIDE: "wgmma_wide"}
PERSISTENT = (WGMMA, WGMMA_WIDE)  # the routes of a row-tile table and a persistent grid
GRID_Y_MAX = 65535  # the decode tile's row tiles are the grid's y dimension


def route(M: int, G: int, int4: bool = False) -> int:
    """The kernel's route, from shapes alone, by the rows a group holds on
    average: the 16-row ``mma.sync`` decode tile below 32 (as kernel H's
    ``uses_prefill_tile``), the ``wgmma`` prefill route from 32, with
    128-wide tiles for int8 and 256-wide ones for packed int4 (``split_sweep
    gqmm``: each faster at 32-103 rows a group)."""
    if M < 32 * G:
        return DECODE
    return WGMMA_WIDE if int4 else WGMMA


def row_tiles(M: int, G: int, bm: int) -> int:
    """The static bound on the groups' tiles of ``bm`` rows, min(ceil(M /
    bm) + G, M), the kernel's ``row_tiles``. Each tile holds at least one
    row and no group wastes more than one tile, so the bound covers any
    counts that sum to at most M."""
    return min(-(-M // bm) + G, M)


def grid(M: int, N: int, G: int, code: int) -> tuple[int, int]:
    """(n tiles, row tiles) of a launch of route ``code``: on the prefill
    routes the units (row tile, n tile) that a persistent grid walks, on the
    decode tile the blocks; the n tile fastest."""
    bm, bn = TILES[code]
    return -(-N // bn), row_tiles(M, G, bm)


def scratch_ints(M: int, G: int, code: int) -> int:
    """int32 of a persistent route's scratch: (group, first row, end row,
    pad) for each row tile of the bound, then the tile count and the rows
    the groups cover; 0 for the decode tile, which takes none."""
    return 4 * row_tiles(M, G, TILES[code][0]) + 2 if code in PERSISTENT else 0


def grouped_quant_matmul(
    x: torch.Tensor,
    weight: torch.Tensor,
    group_sizes: torch.Tensor,
    weight_scale: torch.Tensor,
    x_scale: torch.Tensor,
    output_dtype: torch.dtype,
    int4: bool = False,
) -> torch.Tensor:
    """``out[r, n] = float(sum_k x[r, k] * W[g(r), n, k]) * weight_scale[g(r),
    n] * x_scale[r]``, in that order in fp32, rounded once to ``output_dtype``,
    for int8 ``x`` (M, K) with rows sorted by group, int32 ``group_sizes``
    (G,), ``weight`` int8 (G, N, K) or with ``int4`` packed (G, N // 2, K)
    (``core.operators.moe.unpack_int4``'s layout), fp32 ``weight_scale`` (G,
    N) and ``x_scale`` (M, 1). Rows past the groups' end are zero.

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("grouped_quant_matmul", x, weight, weight_scale, x_scale)
    if x.device.type == "cpu":
        return grouped_quant_matmul_plain(x, weight, group_sizes, weight_scale, x_scale, output_dtype, int4)
    return _group_quant_gemm_kernel(x, weight, group_sizes, weight_scale, x_scale, output_dtype, int4)


def _group_quant_gemm_kernel(x, weight, group_sizes, weight_scale, x_scale, output_dtype, int4):
    global launches
    build.require(output_dtype in QUANT_OUTPUT_DTYPES, f"grouped_quant_matmul: output dtype must be one of "
                                                       f"{QUANT_OUTPUT_DTYPES}, got {output_dtype}")
    build.require(x.ndim == 2 and weight.ndim == 3, "grouped_quant_matmul: x must be 2-D and weight 3-D")
    M, K = x.shape
    G, rows = weight.shape[0], weight.shape[1]
    N = 2 * rows if int4 else rows
    build.require(G > 0 and tuple(weight.shape) == (G, rows, K),
                  f"grouped_quant_matmul: weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    build.require(K % 16 == 0, f"grouped_quant_matmul takes K % 16 == 0, got K = {K}")
    build.require(not int4 or K <= MAX_K, f"grouped_quant_matmul: packed int4 takes K <= {MAX_K}, got {K}")
    build.require(
        group_sizes.dtype == torch.int32 and tuple(group_sizes.shape) == (G,) and group_sizes.is_contiguous(),
        f"grouped_quant_matmul: group_sizes must be contiguous int32 ({G},), got {group_sizes.dtype} "
        f"{tuple(group_sizes.shape)}")
    build.require(
        weight_scale.dtype == torch.float32 and tuple(weight_scale.shape) == (G, N) and weight_scale.is_contiguous(),
        f"grouped_quant_matmul: weight_scale must be contiguous float32 ({G}, {N}), got {weight_scale.dtype} "
        f"{tuple(weight_scale.shape)}")
    build.require(
        x_scale.dtype == torch.float32 and x_scale.numel() == M and x_scale.is_contiguous(),
        f"grouped_quant_matmul: x_scale must be contiguous float32 with {M} values, got {x_scale.dtype} "
        f"{tuple(x_scale.shape)}")
    build.require_device(x.device, weight, group_sizes, weight_scale, x_scale)
    for name, t in (("x", x), ("weight", weight)):
        build.require(t.dtype == torch.int8 and t.is_contiguous() and t.data_ptr() % 16 == 0,
                      f"grouped_quant_matmul: {name} must be contiguous 16-byte aligned int8, got {t.dtype}")
    plan = route(M, G, int4)
    build.require(plan in PERSISTENT or grid(M, N, G, plan)[1] <= GRID_Y_MAX,
                  f"grouped_quant_matmul: {M} rows over {G} groups need more than {GRID_Y_MAX} row tiles")
    out = torch.empty((M, N), dtype=output_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    n_scratch = scratch_ints(M, G, plan)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=x.device) if n_scratch else None
    build.launch(
        "mojo_group_quant_gemm", x.device,
        x.data_ptr(), weight.data_ptr(), group_sizes.data_ptr(), x_scale.data_ptr(), weight_scale.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), n_scratch, M, N, K, G, int(int4), plan,
        build.DTYPE_CODES[output_dtype],
    )
    launches += 1
    name = ROUTE_NAMES[plan]
    launches_by_route[name] = launches_by_route.get(name, 0) + 1
    return out
