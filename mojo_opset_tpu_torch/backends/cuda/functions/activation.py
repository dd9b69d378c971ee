"""cuda-tier training SiLU: kernel L (``csrc/silu.cu``) forward and backward
under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/activation.py:18``
(``PallasSiluFunction`` over ``silu_vjp``). The forward saves x; the
backward recomputes the sigmoid from it. No lane gate (any shape runs the
kernel) and it is the default tier (JAX's ``dispatch_default = False`` was
set from TPU measurements).
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.silu_vjp import silu_bwd, silu_fwd
from mojo_opset_tpu_torch.core.functions.activation import MojoSiluFunction


class SiluVJP(torch.autograd.Function):
    """``apply(x, fwd, bwd)``: ``fwd``/``bwd`` are kernel L's wrappers (a
    plain twin passes their plain versions)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        x = x.contiguous()
        ctx.save_for_backward(x)
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return ctx.bwd(x, dy.to(x.dtype).contiguous()), None, None


class CudaSiluFunction(MojoSiluFunction):
    """``fwd`` and ``bwd`` are kernel L's entry points; a plain twin on the
    card sets them to ``silu_fwd_plain`` and ``silu_bwd_plain``."""

    fwd = staticmethod(silu_fwd)
    bwd = staticmethod(silu_bwd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return SiluVJP.apply(x, self.fwd, self.bwd)
