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
two passes together). ``route`` picks the exact-width kernels (W <= 4) or
the generic ones (W 5-16) from W alone; ``plan`` sizes the grid and the
partial buffer from the shapes alone.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.silu_vjp import silu_bwd_plain

launches = 0  # the forward entry point
launches_bwd = 0

MAX_W = 16  # csrc/conv1d.cu kMaxW: the widest window the kernel takes
EXACT_MAX_W = 4  # csrc/conv1d.cu kExactMaxW: W <= 4 takes the exact-width kernels
CHUNK = 256  # time rows a chunk, both routes (split_sweep conv1d)
MIN_CHUNK = 32  # the exact route's chunks halve down to this while they fill under half the card's blocks
# the exact-width kernels' rows loaded ahead a thread, threads a block, and whether the next rows are loaded before
# the current rows' math (csrc/conv1d.cu kRing, kExactThreads, kPrefetch; split_sweep conv1d sets others)
RING, THREADS, PREFETCH = 4, 128, 1
GENERIC_THREADS = 128  # csrc/conv1d.cu kThreads
GENERIC_MAX_SLOTS = 256  # the generic backward's slots along time


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


def route(W: int) -> str:
    """``exact`` (a kernel instantiated at this W) for W <= 4, else ``generic``."""
    return "exact" if W <= EXACT_MAX_W else "generic"


def blocks_per_sm(bwd: bool, threads: int) -> int:
    """Blocks an SM an exact-width kernel holds at least (its launch bounds,
    csrc/conv1d.cu ``exact_min_blocks``)."""
    return (256 if bwd else 512) // threads


def plan(B: int, T: int, D: int, W: int, vec_width: int, bwd: bool, sms: int = build.H100_SMS
         ) -> Tuple[int, int, int]:
    """``(chunk, channel groups, slots)`` of a launch, from the shapes alone:
    the grid is (channel groups, slots), slot s walking chunks s, s + slots,
    ... of ``chunk`` rows over all sequences, and the backward's partial
    buffer has one row a slot. The exact-width kernels take CHUNK rows
    (halved, down to MIN_CHUNK, while the chunks of all channel groups fill
    under half the blocks the card holds at once) and as many slots as the
    card holds blocks for the channel groups, cut so each takes the same
    number of chunks. The generic kernels take CHUNK rows; their backward at
    most GENERIC_MAX_SLOTS slots, their forward one block a chunk (slots
    unused: 1). ``vec_width``: channels a thread of the exact route owns (16
    bytes' worth, or 1 unaligned)."""
    chunk = CHUNK
    if route(W) == "generic":
        units = B * -(-T // chunk)
        return chunk, -(-D // GENERIC_THREADS), min(units, GENERIC_MAX_SLOTS) if bwd else 1
    groups = -(-D // (THREADS * vec_width))
    resident = sms * blocks_per_sm(bwd, THREADS)
    while chunk > MIN_CHUNK and 2 * B * -(-T // chunk) * groups < resident:
        chunk //= 2
    units = B * -(-T // chunk)
    per_group = max(1, resident // groups)
    return chunk, groups, -(-units // -(-units // per_group))


def _vec_width(vec: bool, x: torch.Tensor) -> int:
    return 16 // x.element_size() if vec else 1


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
    W = weight.shape[1]
    out = torch.empty_like(x)
    if out.numel():
        vec = _vec(D, x, state, out)
        chunk, _, slots = plan(B, T, D, W, _vec_width(vec, x), False, build.sm_count(x.device))
        build.launch("mojo_conv1d_fwd", x.device, *ptrs, out.data_ptr(), B, T, D, W, int(act), int(vec), chunk,
                     slots, RING, THREADS, PREFETCH, code)
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
    vec = _vec(D, x, state, g, dx)
    chunk, _, slots = plan(B, T, D, W, _vec_width(vec, x), True, build.sm_count(x.device))
    part = torch.empty(slots, W + 1, D, dtype=torch.float32, device=x.device)
    dwb = torch.empty(W + 1, D, dtype=torch.float32, device=x.device)
    build.launch("mojo_conv1d_bwd", x.device, *ptrs, g.data_ptr(), dx.data_ptr(), part.data_ptr(), dwb.data_ptr(),
                 B, T, D, W, int(act), int(vec), chunk, slots, RING, THREADS, PREFETCH, code)
    launches_bwd += 1
    return dx, dwb[:W], dwb[W]
