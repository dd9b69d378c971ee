"""Kernel K: the RMSNorm backward (``csrc/rmsnorm_vjp.cu``) and its plain
PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/rmsnorm_vjp.py:56``
(``_rmsnorm_bwd_pallas``, call :59). From x, the fp32 weight and dy, in
fp32: ``rstd = rsqrt(mean(x^2) + eps)``, ``g = dy * w``,
``dx = rstd * g - rstd^3 * x * mean(g * x)`` in x's dtype, and
``dw = sum over rows of dy * x * rstd`` in fp32. The kernel's dw is
deterministic: each block writes fp32 partial sums that a second pass adds
in a fixed order, and the grid depends on the shape alone. ``launches``
counts calls that launched it. ``layout`` picks the register kernel (kernel
A's row layouts, ``norms.row_layout``) from the width, the dtype and the
pointers alone; other widths and unaligned views take the generic row
kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.norms import ROW_BLOCK_THREADS, row_layout

launches = 0

SHORT_MAX_D = 256  # generic rows up to this width take a warp each (csrc/rmsnorm_vjp.cu kShortMaxD)
MAX_D = 49152  # a generic long row's dw sums live in shared memory: 4 bytes a column


def rmsnorm_bwd_plain(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward written out in fp32: ``(dx in x's dtype, fp32 dw)``."""
    D = x.shape[-1]
    xf, dyf = x.float(), dy.float()
    g = dyf * weight.float()
    rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    dx = rstd * g - rstd.pow(3) * xf * (g * xf).mean(-1, keepdim=True)
    dw = (dyf * (xf * rstd)).reshape(-1, D).sum(0)
    return dx.to(x.dtype), dw


def rmsnorm_bwd(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and dy (..., D) of one dtype, fp32 ``weight`` (D,) -> ``(dx, fp32
    dw)``. A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("rmsnorm_bwd", x, weight, dy)
    D = x.shape[-1]
    build.require(dy.shape == x.shape and dy.dtype == x.dtype,
                  f"rmsnorm_bwd: dy must match x, got {dy.dtype} {tuple(dy.shape)} and {x.dtype} {tuple(x.shape)}")
    build.require(weight.dtype == torch.float32 and weight.shape == (D,),
                  f"rmsnorm_bwd: weight must be float32 ({D},), got {weight.dtype} {tuple(weight.shape)}")
    if x.device.type == "cpu":
        return rmsnorm_bwd_plain(x, weight, dy, eps)
    return _rmsnorm_bwd_kernel(x, weight, dy, eps)


def layout(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor):
    """(threads a row, 16-byte vectors a thread) of the register kernel for
    ``x``'s rows, or None (the generic kernels): ``norms.row_layout`` of the
    width and dtype, when x, dy and the weight start on 16-byte boundaries
    (dx is allocated aligned)."""
    if any(t.data_ptr() % 16 for t in (x, dy, weight)):
        return None
    return row_layout(x.shape[-1], x.dtype)


def blocks_per_sm(tpr: int, vpt: int, dtype: torch.dtype) -> int:
    """Blocks an SM the register kernel holds at least (its launch bounds,
    csrc/rmsnorm_vjp.cu ``reg_min_blocks``) and its grid takes, from a
    thread's values."""
    values = vpt * 16 // torch.empty((), dtype=dtype).element_size()
    return 4 if values <= 40 else 2


def grid_blocks(rows: int, D: int, dtype: torch.dtype, reg_layout=None, sms: int = build.H100_SMS) -> int:
    """The row pass's grid, the number of dw partial rows, from the shape
    alone. The register kernel: at most the blocks the card holds at once,
    cut so every block takes the same number of row groups (128 / threads a
    row rows each). The generic kernels: a warp per short row and 8 a block,
    or a block per long row, capped at 4 (short) or 2 (long) blocks an SM."""
    if reg_layout is not None:
        tpr, vpt = reg_layout
        groups = -(-rows // (ROW_BLOCK_THREADS // tpr))
        resident = sms * blocks_per_sm(tpr, vpt, dtype)
        return -(-groups // -(-groups // resident))
    if D <= SHORT_MAX_D:
        return max(1, min(-(-rows // 8), 4 * sms))
    return max(1, min(rows, 2 * sms))


def _rmsnorm_bwd_kernel(x, weight, dy, eps):
    global launches
    D = x.shape[-1]
    code = build.dtype_code(x)
    build.require_device(x.device, weight, dy)
    build.require(0 < D <= MAX_D, f"rmsnorm_bwd takes 0 < D <= {MAX_D}, got {D}")
    build.require(x.is_contiguous() and dy.is_contiguous() and weight.is_contiguous(),
                  "rmsnorm_bwd: x, dy and weight must be contiguous")
    rows = x.numel() // D
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros(D, dtype=torch.float32, device=x.device)
    reg_layout = layout(x, dy, weight)
    blocks = grid_blocks(rows, D, x.dtype, reg_layout, build.sm_count(x.device))
    part = torch.empty(blocks, D, dtype=torch.float32, device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    isz = x.element_size()
    width = 4 if D <= SHORT_MAX_D else 16 // isz  # elements a generic vector load takes
    vec = D % width == 0 and all(t.data_ptr() % (width * isz) == 0 for t in (x, dy, dx))
    tpr, vpt = reg_layout or (0, 0)
    build.launch("mojo_rmsnorm_bwd", x.device, x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), rows, D, float(eps), blocks, int(vec), tpr, vpt, code)
    launches += 1
    return dx, dw
