"""Kernel M: rotate-half RoPE over a strided head-first view
(``csrc/rope_head_first.cu``), forward and backward, and its plain PyTorch
version.

Replaces the JAX package's ``backends/pallas/kernels/rope.py:97``
(``rope_head_first``, call :112) and ``rope.py:128`` (``rope_train``, whose
backward :153-159 is the same kernel with sin negated). q (B, Hq, S, D) and
k (B, Hk, S, D) may have any strides on B, H and S and unit stride on D;
the outputs are allocated like them (``torch.empty_like`` keeps a dense
view's strides), so a token-first (B, S, H, D) tensor passed as
``x.transpose(1, 2)`` comes back token-first, with no copy. The tables are
(S, D), or (B, S, D) with a batch stride, in q's dtype or in fp32. One
launch rotates q and k; ``negate_sin`` gives the backward (rotate-half is
a rotation, so its transpose is the same map with -sin) without a negated
copy of the table. Math in fp32, one rounding to q's dtype. ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0

_MAX_PAIRS = 2**31  # the kernel indexes (tensor, b, h, s, pair) in 32 bits


def _rotate_plain(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    xf = x.float()
    out = torch.empty_like(x)  # x's strides, as the kernel's output
    out[..., :h] = xf[..., :h] * c[..., :h] - xf[..., h:] * s[..., :h]
    out[..., h:] = xf[..., h:] * c[..., h:] + xf[..., :h] * s[..., h:]
    return out


def rope_head_first_plain(q, k, cos, sin, negate_sin: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half in fp32, cast to the input dtype: the TPU kernel's math
    (rope.py:72-86), on the same layouts as the kernel."""
    c, s = cos.float(), sin.float()
    if negate_sin:
        s = -s
    if c.ndim == 3:  # (B, S, D): one table a batch row, broadcast over the heads
        c, s = c[:, None], s[:, None]
    return _rotate_plain(q, c, s), _rotate_plain(k, c, s)


def _check(q, k, cos, sin) -> None:
    build.require(q.ndim == 4 and k.ndim == 4, "rope_head_first: q and k must be (B, H, S, D)")
    B, _, S, D = q.shape
    build.require(k.shape[0] == B and k.shape[2] == S and k.shape[3] == D and D % 2 == 0,
                  f"rope_head_first: q {tuple(q.shape)} and k {tuple(k.shape)} need one B, one S and one even D")
    build.require(cos.shape == sin.shape and cos.shape in ((S, D), (B, S, D)),
                  f"rope_head_first: cos/sin must be ({S}, {D}) or ({B}, {S}, {D}) full-rope tables, got "
                  f"{tuple(cos.shape)} and {tuple(sin.shape)}")
    build.require(k.dtype == q.dtype, f"rope_head_first: q and k must share one dtype, got {q.dtype} and {k.dtype}")
    build.require(cos.dtype == sin.dtype and cos.dtype in (q.dtype, torch.float32),
                  f"rope_head_first: cos and sin must be in q's dtype or float32, got {cos.dtype}, {sin.dtype}")


def rope_head_first(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    negate_sin: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, Hq, S, D), k (B, Hk, S, D), cos/sin (S, D) or (B, S, D) ->
    rotated (q, k), laid out like q and k. A CPU tensor takes the plain
    version; a CUDA tensor the kernel."""
    build.require_no_grad("rope_head_first", q, k, cos, sin)
    _check(q, k, cos, sin)
    if q.device.type == "cpu":
        return rope_head_first_plain(q, k, cos, sin, negate_sin)
    return _rope_kernel(q, k, cos, sin, negate_sin)


def _rope_kernel(q, k, cos, sin, negate_sin):
    global launches
    code = build.dtype_code(q)
    build.require_device(q.device, k, cos, sin)
    build.require(all(t.stride(-1) == 1 for t in (q, k, cos, sin)),
                  "rope_head_first: q, k, cos and sin must have unit stride on D")
    B, Hq, S, D = q.shape
    Hk = k.shape[1]
    build.require(B * (Hq + Hk) * S * (D // 2) < _MAX_PAIRS, "rope_head_first: more than 2^31 pairs")
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)  # a view that is not dense comes back contiguous
    if q.numel() == 0 and k.numel() == 0:
        return q_out, k_out
    if sin.stride() != cos.stride():  # one set of table strides serves both
        cos, sin = cos.contiguous(), sin.contiguous()
    tab = (0, *cos.stride()[:1]) if cos.ndim == 2 else cos.stride()[:2]
    strides = [*q.stride()[:3], *k.stride()[:3], *q_out.stride()[:3], *k_out.stride()[:3], *tab]
    vec = (D // 2) % 4 == 0 and all(st % 4 == 0 for st in strides) and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in (q, k, cos, sin, q_out, k_out))
    arr = (ctypes.c_longlong * len(strides))(*strides)
    build.launch("mojo_rope_head_first", q.device, q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 q_out.data_ptr(), k_out.data_ptr(), ctypes.addressof(arr), B, S, Hq, Hk, D,
                 int(cos.dtype != q.dtype), int(negate_sin), int(vec), code)
    launches += 1
    return q_out, k_out
