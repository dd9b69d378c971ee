"""Kernel H: ragged grouped GEMM (``csrc/group_gemm.cu``) and its plain
PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/group_gemm.py:220``
(``grouped_matmul``). ``launches`` counts the wrapper's launches. The
counts stay on the device: the kernel finds each block's group itself (the
prefill tile from a row-tile table that its first launch writes to a
scratch buffer), so a launch never waits for the host.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.gemm import grouped_matmul_reference as grouped_matmul_plain

launches = 0

PREFILL_TILE_ROWS = 128  # rows of the prefill tile's output tile


def uses_prefill_tile(M: int, G: int, dtype: torch.dtype) -> bool:
    """The kernel's route, from shapes alone: 16-bit inputs with at least 32
    rows a group on average take the wgmma prefill tile (M >= 32 G), others
    the 16-row decode tile or, in fp32, the FMA kernel."""
    return dtype != torch.float32 and M >= 32 * G


def prefill_scratch_ints(M: int, G: int) -> int:
    """int32 of the prefill tile's scratch: (group, first row, end row, pad)
    for each of at most ceil(M / 128) + G row tiles, then the tile count and
    the rows the groups cover."""
    return 4 * (-(-M // PREFILL_TILE_ROWS) + G) + 2


def grouped_matmul(
    x: torch.Tensor, weights: torch.Tensor, group_sizes: torch.Tensor, trans_weight: bool = False
) -> torch.Tensor:
    """``out[r] = x[r] @ weights[group_of(r)]`` for ``x`` (M, K) with rows
    sorted by group, ``weights`` (G, K, N), or (G, N, K) with
    ``trans_weight``, and int32 ``group_sizes`` (G,). fp32 sums, output in
    ``x.dtype``; rows past the groups' end are zero.

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("grouped_matmul", x, weights)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, weights, group_sizes, trans_weight)
    return _group_gemm_kernel(x, weights, group_sizes, trans_weight)


def _group_gemm_kernel(x, weights, group_sizes, trans_weight):
    global launches
    build.require(x.ndim == 2 and weights.ndim == 3, "grouped_matmul: x must be 2-D and weights 3-D")
    code = build.dtype_code(x)
    build.require(weights.dtype == x.dtype, f"grouped_matmul: x and weights share one dtype, got {x.dtype} "
                                            f"and {weights.dtype}")
    M, K = x.shape
    G = weights.shape[0]
    N = weights.shape[1] if trans_weight else weights.shape[2]
    build.require(
        tuple(weights.shape) == ((G, N, K) if trans_weight else (G, K, N)),
        f"grouped_matmul: weights {tuple(weights.shape)} do not match x {tuple(x.shape)} "
        f"(trans_weight={trans_weight})",
    )
    build.require(G > 0, "grouped_matmul: weights hold no group")
    build.require(
        group_sizes.dtype == torch.int32 and group_sizes.shape == (G,) and group_sizes.is_contiguous(),
        f"grouped_matmul: group_sizes must be contiguous int32 ({G},), got {group_sizes.dtype} "
        f"{tuple(group_sizes.shape)}",
    )
    build.require_device(x.device, weights, group_sizes)
    for name, t in (("x", x), ("weights", weights)):
        build.require(t.is_contiguous() and t.data_ptr() % 16 == 0, f"grouped_matmul: {name} must be contiguous "
                                                                    f"and 16-byte aligned")
    if x.dtype != torch.float32:
        build.require(K % 8 == 0, f"grouped_matmul: 16-bit inputs need K % 8 == 0, got K = {K}")
        build.require(trans_weight or N % 8 == 0, f"grouped_matmul: a (G, K, N) weight needs N % 8 == 0, "
                                                  f"got N = {N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    scratch = None
    if uses_prefill_tile(M, G, x.dtype):
        scratch = torch.empty(prefill_scratch_ints(M, G), dtype=torch.int32, device=x.device)
    build.launch(
        "mojo_group_gemm", x.device,
        x.data_ptr(), weights.data_ptr(), group_sizes.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel(),
        M, N, K, G, int(trans_weight), code,
    )
    launches += 1
    return out
