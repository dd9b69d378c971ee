"""cuda-tier training RoPE: kernel M (``csrc/rope_head_first.cu``) forward
and backward under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/position_embedding.py:21``
(``PallasApplyRoPEFunction`` over ``rope_train``). Both layouts run on M,
which takes a strided (B, H, S, D) view: head-first q/k as they are,
token-first (B, S, H, D) through ``transpose(-3, -2)`` (no copy; the
outputs come back token-first), and a 3-D (T, H, D) or (H, T, D) with
(T, D) tables as B = 1. The backward is M on the output gradients with sin
negated. cos and sin get no gradient (JAX :159 returns zeros for them).
What M does not take (mixed q/k dtypes, partial-rope tables) raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.rope_head_first import rope_head_first
from mojo_opset_tpu_torch.core.functions.position_embedding import MojoApplyRoPEFunction


def rotate_layout(rotate, q, k, cos, sin, head_first: bool, negate_sin: bool = False):
    """``rotate`` (M's wrapper or its plain version) on q and k in either
    layout, 3-D or 4-D: they go to it as (B, H, S, D) views, and its outputs
    come back in the callers' layout."""
    if q.ndim != k.ndim or q.ndim not in (3, 4):
        raise ValueError("q and k must both be 3D or 4D")
    views = [x[None] if x.ndim == 3 else x for x in (q, k)]
    if not head_first:
        views = [x.transpose(-3, -2) for x in views]
    outs = rotate(*views, cos, sin, negate_sin)
    if not head_first:
        outs = [x.transpose(-3, -2) for x in outs]
    return tuple(x[0] if q.ndim == 3 else x for x in outs)


class RoPEVJP(torch.autograd.Function):
    """``apply(q, k, cos, sin, head_first, rotate)``: ``rotate`` is M's
    dispatching wrapper (a plain twin passes its plain version)."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, head_first, rotate):
        ctx.save_for_backward(cos, sin)
        ctx.head_first, ctx.rotate = head_first, rotate
        return rotate_layout(rotate, q, k, cos, sin, head_first)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors
        dq, dk = (g if g.stride(-1) == 1 else g.contiguous() for g in (dq, dk))
        dq, dk = rotate_layout(ctx.rotate, dq, dk, cos, sin, ctx.head_first, negate_sin=True)
        return dq, dk, None, None, None, None


class CudaApplyRoPEFunction(MojoApplyRoPEFunction):
    """``rotate`` is kernel M's wrapper; a plain twin on the card sets it to
    ``rope_head_first_plain``."""

    rotate = staticmethod(rope_head_first)

    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        head_first: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        return RoPEVJP.apply(q, k, cos.detach(), sin.detach(), head_first, self.rotate)
