"""Kernel A: RMSNorm, and kernel P: residual add + RMSNorm
(``csrc/rmsnorm.cu``), with their plain PyTorch versions.

A replaces the JAX package's ``backends/pallas/kernels/norms.py:45``
(``rmsnorm``), P its ``norms.py:82`` (``residual_add_rmsnorm``, body
``_add_rmsnorm_kernel`` :68, call :96). ``launches`` counts A's launches,
``launches_residual_add`` P's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.core.operators.normalization import rms_norm as rmsnorm_plain

launches = 0
launches_residual_add = 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim of ``x``; fp32 ``weight`` (D,).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("rmsnorm", x, weight)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    return _rmsnorm_kernel(x, weight, eps)


def _rmsnorm_kernel(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    D = x.shape[-1]
    code = build.dtype_code(x)
    build.require_device(x.device, weight)
    build.require(x.is_contiguous(), "rmsnorm: x must be contiguous")
    _require_weight("rmsnorm", weight, D)
    out = torch.empty_like(x)
    vec = (D * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    build.launch(
        "mojo_rmsnorm", x.device,
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // max(D, 1), D, float(eps), int(vec), code,
    )
    launches += 1
    return out


def _require_weight(name: str, weight: torch.Tensor, D: int) -> None:
    build.require(
        weight.dtype == torch.float32 and weight.shape == (D,) and weight.is_contiguous(),
        f"{name}: weight must be contiguous float32 ({D},), got {weight.dtype} {tuple(weight.shape)}",
    )


def residual_add_rmsnorm_plain(hidden: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, eps: float,
                               norm_pos: str = "pre") -> Tuple[torch.Tensor, torch.Tensor]:
    """What the TPU kernel computes: ``s = hidden + residual`` in fp32,
    ``out = s * rsqrt(mean(s^2) + eps) * w``; the new residual is ``s`` in
    ``pre`` (in the inputs' promoted dtype) and ``out`` in ``post`` (in
    hidden's). The golden op rounds ``s`` to that dtype before the norm."""
    s = hidden.float() + residual.float()
    out = rmsnorm_plain(s, weight, eps)  # fp32, as s is
    if norm_pos == "pre":
        return out.to(hidden.dtype), s.to(torch.result_type(hidden, residual))
    out = out.to(hidden.dtype)
    return out, out


def residual_add_rmsnorm(hidden: torch.Tensor, residual: torch.Tensor, weight: torch.Tensor, eps: float,
                         norm_pos: str = "pre") -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual add + RMSNorm over the last dim: ``(out, new residual)`` as
    ``residual_add_rmsnorm_plain`` gives them. ``residual`` is in hidden's
    dtype or float32, ``weight`` fp32 (D,). A CPU tensor takes the plain
    version; a CUDA tensor the kernel."""
    build.require_no_grad("residual_add_rmsnorm", hidden, residual, weight)
    build.require(norm_pos in ("pre", "post"),
                  f"residual_add_rmsnorm: norm_pos must be 'pre' or 'post', got {norm_pos!r}")
    build.require(residual.shape == hidden.shape,
                  f"residual_add_rmsnorm: residual {tuple(residual.shape)} must match hidden {tuple(hidden.shape)}")
    build.require(residual.dtype in (hidden.dtype, torch.float32),
                  f"residual_add_rmsnorm: the residual must be in hidden's dtype or float32, got {residual.dtype} "
                  f"beside {hidden.dtype}")
    _require_weight("residual_add_rmsnorm", weight, hidden.shape[-1])
    if hidden.device.type == "cpu":
        return residual_add_rmsnorm_plain(hidden, residual, weight, eps, norm_pos)
    return _residual_add_rmsnorm_kernel(hidden, residual, weight, eps, norm_pos)


def _residual_add_rmsnorm_kernel(hidden, residual, weight, eps, norm_pos):
    global launches_residual_add
    D = hidden.shape[-1]
    code = build.dtype_code(hidden)
    build.require_device(hidden.device, residual, weight)
    build.require(hidden.is_contiguous() and residual.is_contiguous(),
                  "residual_add_rmsnorm: hidden and residual must be contiguous")
    pre = norm_pos == "pre"
    out = torch.empty_like(hidden)
    new_residual = torch.empty_like(residual if pre else hidden)
    # a vector holds 16 bytes of hidden's dtype; an fp32 residual takes two
    width = 16 // hidden.element_size()
    vec = D % width == 0 and all(t.data_ptr() % 16 == 0 for t in (hidden, residual, out, new_residual))
    if hidden.numel():
        build.launch(
            "mojo_residual_add_rmsnorm", hidden.device,
            hidden.data_ptr(), residual.data_ptr(), weight.data_ptr(), out.data_ptr(), new_residual.data_ptr(),
            hidden.numel() // D, D, float(eps), int(not pre), int(residual.dtype != hidden.dtype), int(vec), code,
        )
        launches_residual_add += 1
    return out, new_residual
