"""cuda-tier diffusion attention: kernel O (``csrc/flash_diffusion.cu``)
forward and backward under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/diffusion_attention.py:31``
(``PallasDiffusionAttentionFunction`` over ``flash_diffusion``'s
``jax.custom_vjp``). The forward runs O's forward and saves
``(q, k, v, o, lse)``; the backward runs O's dq kernel (which also writes
``delta = rowsum(do * o)``) and then its dk/dv kernel, as ``FlashSWA``
does. An additive float mask takes the golden, as JAX's tier does
(:41-55), counted in ``golden_calls``. None of JAX's TPU gates is carried
over: no ``D % 128`` gate, no f16 exclusion, any mask that broadcasts to
(B, Hq, Sq, Sk) and Sq != Sk. What O does not take raises.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.flash_diffusion import flash_diffusion_bwd, flash_diffusion_fwd
from mojo_opset_tpu_torch.experimental.functions.diffusion_attention import MojoDiffusionAttentionFunction


class FlashDiffusion(torch.autograd.Function):
    """``apply(q, k, v, mask, scale, empty)``: ``empty`` is the output of a
    row whose mask keeps no key."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, empty):
        o, lse = flash_diffusion_fwd(q, k, v, mask, scale, empty)
        ctx.save_for_backward(q, k, v, o, lse, mask)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_diffusion_bwd(q, k, v, o, lse, do.contiguous(), mask, ctx.scale)
        return dq, dk, dv, None, None, None


def diffusion_attention(query, key, value, mask, scale=None, empty=0.0, enable_gqa=False) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, D) over k/v (B, Hkv, Sk, D) under the bool
    keep-mask on kernel O, differentiable in q, k and v."""
    if query.shape[1] != key.shape[1] and not enable_gqa:
        raise ValueError(f"{query.shape[1]} query heads over {key.shape[1]} kv heads need enable_gqa=True")
    return FlashDiffusion.apply(query.contiguous(), key.contiguous(), value.contiguous(), mask, scale, empty)


class CudaDiffusionAttentionFunction(MojoDiffusionAttentionFunction):
    """A bool mask runs ``FlashDiffusion`` (a row that keeps no key gives 0
    and zero gradients); an additive mask takes the golden, counted in
    ``golden_calls``."""

    golden_calls = 0

    def forward(self, query, key, value, mask, scale: float = 1.0, enable_gqa: bool = False):
        if mask.dtype != torch.bool:
            CudaDiffusionAttentionFunction.golden_calls += 1
            return super().forward(query, key, value, mask, scale, enable_gqa)
        return diffusion_attention(query, key, value, mask, scale, 0.0, enable_gqa)
