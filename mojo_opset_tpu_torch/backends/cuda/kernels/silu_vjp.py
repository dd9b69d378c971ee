"""Kernel L: SiLU forward and backward (``csrc/silu.cu``) and their plain
PyTorch versions.

Replaces the JAX package's ``backends/pallas/kernels/silu_vjp.py`` (the
forward ``_fwd_kernel`` :30, call :52; the backward ``_bwd_kernel`` :35,
call :71). The forward is ``x * sigmoid(x)``; the backward recomputes the
sigmoid from the saved x: ``dx = dy * s * (1 + x * (1 - s))``. Math in
fp32, the result in x's dtype, any shape (no lane condition). ``launches``
counts the forward's launches, ``launches_bwd`` the backward's.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0  # the forward entry point
launches_bwd = 0


def silu_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x.float()).to(x.dtype)


def silu_bwd_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The backward written out in fp32."""
    xf = x.float()
    s = torch.sigmoid(xf)
    return (dy.float() * s * (1.0 + xf * (1.0 - s))).to(x.dtype)


def silu_fwd(x: torch.Tensor) -> torch.Tensor:
    """SiLU of ``x``; a CPU tensor takes the plain version, a CUDA tensor the
    kernel."""
    build.require_no_grad("silu_fwd", x)
    if x.device.type == "cpu":
        return silu_fwd_plain(x)
    global launches
    code = build.dtype_code(x)
    build.require(x.is_contiguous(), "silu_fwd: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel():
        vec = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
        build.launch("mojo_silu_fwd", x.device, x.data_ptr(), y.data_ptr(), x.numel(), int(vec), code)
        launches += 1
    return y


def silu_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The gradient of SiLU at ``x`` for the output gradient ``dy``, in x's
    dtype; a CPU tensor takes the plain version, a CUDA tensor the kernel."""
    build.require_no_grad("silu_bwd", x, dy)
    build.require(dy.shape == x.shape and dy.dtype == x.dtype,
                  f"silu_bwd: dy must match x, got {dy.dtype} {tuple(dy.shape)} and {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return silu_bwd_plain(x, dy)
    global launches_bwd
    code = build.dtype_code(x)
    build.require_device(x.device, dy)
    build.require(x.is_contiguous() and dy.is_contiguous(), "silu_bwd: x and dy must be contiguous")
    dx = torch.empty_like(x)
    if x.numel():
        vec = all(t.data_ptr() % 16 == 0 for t in (x, dy, dx))
        build.launch("mojo_silu_bwd", x.device, x.data_ptr(), dy.data_ptr(), dx.data_ptr(), x.numel(), int(vec),
                     code)
        launches_bwd += 1
    return dx
