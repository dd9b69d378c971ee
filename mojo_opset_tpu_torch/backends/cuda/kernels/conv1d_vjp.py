"""Kernel Q: causal depthwise conv1d (+ bias, + SiLU) forward and backward
(``csrc/conv1d.cu``), and their plain PyTorch versions.

Replaces the JAX package's ``backends/pallas/kernels/conv1d_vjp.py:212``
(``conv1d_train``: ``_fwd_kernel`` :73, call :149; ``_bwd_kernel`` :88,
call :188). Over the stream ``[state rows -(W-1)..-1] ++ x`` of each
sequence, in fp32: ``z[t] = b + sum_w stream[t + w] * k[w]``,
``out[t] = silu(z[t])`` (or ``z[t]``); the backward recomputes z and gives
``dz = g * silu'(z)``, ``dx[j] = sum_w dz[j + W-1 - w] * k[w]``, fp32
``dw`` (W, D) and ``db`` (D,). The kernel's dw and db are deterministic:
each block writes fp32 partial sums that a second pass adds in a fixed
order, and the blocks' work depends on the shape alone. ``launches`` counts
the forward's launches, ``launches_bwd`` the backward's (one a call, its
two passes together).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.silu_vjp import silu_bwd_plain

launches = 0  # the forward entry point
launches_bwd = 0

MAX_W = 16  # csrc/conv1d.cu kMaxW: the widest window the kernel takes
MAX_SLOTS = 256  # rows of the backward's dw/db partial buffer; the kernel uses as many as it has chunks


def conv_z(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor) -> torch.Tensor:
    """``z[t] = b + sum_w stream[t + w] * k[w]`` over the stream
    ``[state ++ x]``, for every row t of x, as W shifted multiply-adds in
    fp32; ``weight`` is (D, W)."""
    stream = torch.cat([state.float(), x.float()], dim=1)
    T = x.shape[1]
    k = weight.float()
    z = torch.zeros_like(stream[:, :T]) if bias is None else bias.float().expand_as(stream[:, :T])
    for w in range(k.shape[1]):
        z = z + stream[:, w:w + T] * k[:, w]
    return z


def conv1d_fwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor,
                     act: bool) -> torch.Tensor:
    """The forward written out in fp32: ``act(z)`` in x's dtype."""
    z = conv_z(x, weight, bias, state)
    return (z * torch.sigmoid(z) if act else z).to(x.dtype)


def conv1d_bwd_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor,
                     g: torch.Tensor, act: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward written out in fp32: ``(dx in x's dtype, fp32 dw (W, D),
    fp32 db (D,))``."""
    B, T, D = x.shape
    W = weight.shape[1]
    stream = torch.cat([state.float(), x.float()], dim=1)
    dz = g.float()
    if act:
        dz = silu_bwd_plain(conv_z(x, weight, bias, state), dz)
    k = weight.float()
    dz_pad = torch.cat([dz, dz.new_zeros(B, W - 1, D)], dim=1)  # dz = 0 past T
    dx = torch.zeros_like(dz)
    for w in range(W):  # dx[j] = sum_w dz[j + W-1 - w] * k[w]: the anti-causal correlation
        dx = dx + dz_pad[:, W - 1 - w:W - 1 - w + T] * k[:, w]
    dw = torch.stack([(dz * stream[:, w:w + T]).sum((0, 1)) for w in range(W)])
    return dx.to(x.dtype), dw, dz.sum((0, 1))


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           state: torch.Tensor) -> None:
    build.require(x.ndim == 3, f"{name}: x must be (B, T, D), got {tuple(x.shape)}")
    B, _, D = x.shape
    build.require(weight.ndim == 2 and weight.shape[0] == D and weight.dtype == torch.float32,
                  f"{name}: weight must be float32 (D, W) = ({D}, W), got {weight.dtype} {tuple(weight.shape)}")
    W = weight.shape[1]
    build.require(1 <= W <= MAX_W, f"{name}: the kernel takes 1 <= W <= {MAX_W}, got W = {W}")
    build.require(bias is None or (bias.dtype == torch.float32 and bias.shape == (D,)),
                  f"{name}: bias must be float32 ({D},) or None")
    build.require(state.shape == (B, W - 1, D) and state.dtype == x.dtype,
                  f"{name}: state must be {x.dtype} ({B}, {W - 1}, {D}), got {state.dtype} {tuple(state.shape)}")


def _pointers(x, weight, bias, state):
    build.require_device(x.device, weight, state, *([] if bias is None else [bias]))
    build.require(all(t.is_contiguous() for t in (x, weight, state)) and (bias is None or bias.is_contiguous()),
                  "conv1d: x, weight, bias and state must be contiguous")
    return x.data_ptr(), state.data_ptr(), weight.data_ptr(), None if bias is None else bias.data_ptr()


def _vec(D: int, *tensors: torch.Tensor) -> bool:
    """16-byte vectors: D a multiple of 16 bytes' worth of elements and every
    row tensor 16-byte aligned (the state of W = 1 holds no rows)."""
    return D % (16 // tensors[0].element_size()) == 0 and all(t.data_ptr() % 16 == 0 for t in tensors if t.numel())


def conv1d_fwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor,
               act: bool) -> torch.Tensor:
    """x (B, T, D), fp32 ``weight`` (D, W), fp32 ``bias`` (D,) or None,
    ``state`` (B, W-1, D) in x's dtype -> ``act(z)`` (B, T, D) in x's dtype.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("conv1d_fwd", x, weight, bias, state)
    _check("conv1d_fwd", x, weight, bias, state)
    if x.device.type == "cpu":
        return conv1d_fwd_plain(x, weight, bias, state, act)
    global launches
    B, T, D = x.shape
    code = build.dtype_code(x)
    ptrs = _pointers(x, weight, bias, state)
    out = torch.empty_like(x)
    if out.numel():
        build.launch("mojo_conv1d_fwd", x.device, *ptrs, out.data_ptr(), B, T, D, weight.shape[1], int(act),
                     int(_vec(D, x, state, out)), code)
        launches += 1
    return out


def conv1d_bwd(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor,
               g: torch.Tensor, act: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients for the output gradient ``g`` (x's shape and dtype):
    ``(dx in x's dtype, fp32 dw (W, D), fp32 db (D,))``. A CPU tensor takes
    the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("conv1d_bwd", x, weight, bias, state, g)
    _check("conv1d_bwd", x, weight, bias, state)
    build.require(g.shape == x.shape and g.dtype == x.dtype,
                  f"conv1d_bwd: g must match x, got {g.dtype} {tuple(g.shape)} and {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return conv1d_bwd_plain(x, weight, bias, state, g, act)
    global launches_bwd
    B, T, D = x.shape
    W = weight.shape[1]
    code = build.dtype_code(x)
    ptrs = _pointers(x, weight, bias, state)
    build.require_device(x.device, g)
    build.require(g.is_contiguous(), "conv1d_bwd: g must be contiguous")
    dx = torch.empty_like(x)
    if not dx.numel():
        return dx, torch.zeros(W, D, device=x.device), torch.zeros(D, device=x.device)
    part = torch.empty(MAX_SLOTS, W + 1, D, dtype=torch.float32, device=x.device)
    dwb = torch.empty(W + 1, D, dtype=torch.float32, device=x.device)
    build.launch("mojo_conv1d_bwd", x.device, *ptrs, g.data_ptr(), dx.data_ptr(), part.data_ptr(), dwb.data_ptr(),
                 B, T, D, W, int(act), MAX_SLOTS, int(_vec(D, x, state, g, dx)), code)
    launches_bwd += 1
    return dx, dwb[:W], dwb[W]
