"""Kernel K: the RMSNorm backward (``csrc/rmsnorm_vjp.cu``) and its plain
PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/rmsnorm_vjp.py:56``
(``_rmsnorm_bwd_pallas``, call :59). From x, the fp32 weight and dy, in
fp32: ``rstd = rsqrt(mean(x^2) + eps)``, ``g = dy * w``,
``dx = rstd * g - rstd^3 * x * mean(g * x)`` in x's dtype, and
``dw = sum over rows of dy * x * rstd`` in fp32. The kernel's dw is
deterministic: each block writes fp32 partial sums that a second pass adds
in a fixed order, and the grid depends on the shape alone. ``launches``
counts calls that launched it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0

SHORT_MAX_D = 256  # rows up to this width take a warp each (csrc/rmsnorm_vjp.cu kShortMaxD)
MAX_D = 49152  # a long row's dw sums live in shared memory: 4 bytes a column
SMS = 132


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


def _grid_blocks(rows: int, D: int) -> int:
    """The row pass's grid: a warp per short row and 8 a block, or a block
    per long row, capped at 4 (short) or 2 (long) blocks an SM; the number
    of dw partial rows."""
    if D <= SHORT_MAX_D:
        return max(1, min(-(-rows // 8), 4 * SMS))
    return max(1, min(rows, 2 * SMS))


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
    blocks = _grid_blocks(rows, D)
    part = torch.empty(blocks, D, dtype=torch.float32, device=x.device)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    isz = x.element_size()
    width = 4 if D <= SHORT_MAX_D else 16 // isz  # elements a vector load takes
    vec = D % width == 0 and all(t.data_ptr() % (width * isz) == 0 for t in (x, dy, dx))
    build.launch("mojo_rmsnorm_bwd", x.device, x.data_ptr(), weight.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), rows, D, float(eps), blocks, int(vec), code)
    launches += 1
    return dx, dw
