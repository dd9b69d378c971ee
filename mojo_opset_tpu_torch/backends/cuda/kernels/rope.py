"""Kernel B: token-first RoPE (``csrc/rope.cu``) and its plain PyTorch version.

Replaces the JAX package's ``backends/pallas/kernels/rope.py:166``
(``rope_token_first``). One launch rotates q and k together.
``launches`` counts kernel launches. ``route`` picks the kernel's route
from shapes and pointers alone: the vector route (16-byte vectors, a
token's tables shared by its heads) at the head dims in
``VECTOR_WIDTHS``, the generic scalar kernel otherwise.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda import build

launches = 0

# head dims the vector route instantiates: DeepSeek-V3's rope lanes (64), Qwen3's and Seed-OSS's heads (128)
VECTOR_WIDTHS = (64, 128)
# the vector route's threads a block (csrc/rope.cu takes 128 or 256)
THREADS = 128


def _rotate_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    xf, c, s = x.float(), cos.float()[:, None, :], sin.float()[:, None, :]
    lo = xf[..., :h] * c[..., :h] - xf[..., h:] * s[..., :h]
    hi = xf[..., h:] * c[..., h:] + xf[..., :h] * s[..., h:]
    return torch.cat([lo, hi], dim=-1).to(x.dtype)


def rope_token_first_plain(q, k, cos, sin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate-half in fp32, cast to the input dtype: the TPU kernel's math
    (rope.py:72-79)."""
    return _rotate_plain(q, cos, sin), _rotate_plain(k, cos, sin)


def _check(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> None:
    build.require(q.ndim == 3 and k.ndim == 3, "rope_token_first: q and k must be (T, H, D)")
    T, _, D = q.shape
    build.require(
        k.shape[0] == T and k.shape[2] == D and D % 2 == 0,
        f"rope_token_first: q {tuple(q.shape)} and k {tuple(k.shape)} need one T and one even D",
    )
    build.require(
        cos.shape == (T, D) and sin.shape == (T, D),
        f"rope_token_first: cos/sin must be ({T}, {D}) full-rope tables, got {tuple(cos.shape)}",
    )


def route(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> str:
    """``"vector"`` when the head dim is in ``VECTOR_WIDTHS``, every input
    starts on a 16-byte boundary and q and k together hold fewer than 2^31
    elements (the route's offsets are 32-bit); ``"generic"`` otherwise.
    Contiguous inputs are assumed (the wrapper requires them); the outputs
    are new, so aligned."""
    vector = (q.shape[-1] in VECTOR_WIDTHS and all(t.data_ptr() % 16 == 0 for t in (q, k, cos, sin))
              and q.numel() + k.numel() < 2**31)
    return "vector" if vector else "generic"


def rope_token_first(
    q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (T, Hq, D), k (T, Hk, D), cos/sin (T, D) -> rotated (q, k).

    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    build.require_no_grad("rope_token_first", q, k, cos, sin)
    _check(q, k, cos, sin)
    if q.device.type == "cpu":
        return rope_token_first_plain(q, k, cos, sin)
    return _rope_kernel(q, k, cos, sin)


def _rope_kernel(q, k, cos, sin):
    global launches
    code = build.dtype_code(q)
    build.require_device(q.device, k, cos, sin)
    build.require(
        k.dtype == q.dtype and cos.dtype == q.dtype and sin.dtype == q.dtype,
        f"rope_token_first: q, k, cos and sin must share one dtype, got "
        f"{q.dtype}, {k.dtype}, {cos.dtype}, {sin.dtype}",
    )
    build.require(
        all(t.is_contiguous() for t in (q, k, cos, sin)), "rope_token_first: inputs must be contiguous"
    )
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    T, Hq, D = q.shape
    build.launch(
        "mojo_rope_token_first", q.device,
        q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), q_out.data_ptr(), k_out.data_ptr(),
        T, Hq, k.shape[1], D, int(route(q, k, cos, sin) == "vector"), THREADS, code,
    )
    launches += 1
    return q_out, k_out
