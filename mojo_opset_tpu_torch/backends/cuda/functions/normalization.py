"""cuda-tier training RMSNorm: kernel A (``csrc/rmsnorm.cu``) forward and
kernel K (``csrc/rmsnorm_vjp.cu``) backward under one
``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/normalization.py:18``
(``PallasRMSNormFunction`` over ``rmsnorm_vjp``'s ``jax.custom_vjp``). The
forward saves x and the weight, not the normalized output: K recomputes
rstd. Kernels A and K take an fp32 weight; a bf16 or fp16 weight is
converted for them, and its gradient comes back in its own dtype (JAX
``rmsnorm_vjp.py:103``). None of the TPU tier's detours is carried over: no
``D % 128`` gate, no f16 -> fp32 upcast, and it is the default tier
(JAX's ``dispatch_default = False`` was set from TPU measurements).
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.norms import rmsnorm
from mojo_opset_tpu_torch.backends.cuda.kernels.rmsnorm_vjp import rmsnorm_bwd
from mojo_opset_tpu_torch.core.functions.normalization import MojoRMSNormFunction


class RMSNormVJP(torch.autograd.Function):
    """``apply(x, weight, eps, fwd, bwd)``: ``fwd``/``bwd`` are kernel A's
    and kernel K's dispatching wrappers (a plain twin passes their plain
    versions)."""

    @staticmethod
    def forward(ctx, x, weight, eps, fwd, bwd):
        x = x.contiguous()
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.bwd = eps, bwd
        return fwd(x, weight.float().contiguous(), eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = ctx.bwd(x, weight.float().contiguous(), dy.to(x.dtype).contiguous(), ctx.eps)
        return dx, dw.to(weight.dtype), None, None, None


class CudaRMSNormFunction(MojoRMSNormFunction):
    """``fwd`` and ``bwd`` are kernel A's and K's wrappers; a plain twin on the
    card sets them to ``rmsnorm_plain`` and ``rmsnorm_bwd_plain``."""

    fwd = staticmethod(rmsnorm)
    bwd = staticmethod(rmsnorm_bwd)

    def forward(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return RMSNormVJP.apply(x, weight, self.eps, self.fwd, self.bwd)
