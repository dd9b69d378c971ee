"""Autograd attention under an arbitrary mask, for text-diffusion models.

Counterpart of the JAX package's ``experimental/functions/diffusion_attention.py``
(``MojoDiffusionAttentionFunction`` :23, ``mojo_diffusion_attention`` :43,
``block_diffusion_mask`` :49). The golden (``ref``) tier is autograd of
``MojoSdpa``'s golden with the mask; the cuda tier
(``CudaDiffusionAttentionFunction``) runs kernel O forward and backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operators.attention import MojoSdpa


class MojoDiffusionAttentionFunction(MojoFunction):
    """q (B, Hq, S, D), k/v (B, Hkv, S, D) under a bool keep-mask (True =
    attend) or an additive float mask that broadcasts to (B, Hq, S, S);
    differentiable in q, k and v. ``scale`` defaults to 1.0, as in JAX. A
    row whose bool mask keeps no key gives NaN here (the golden softmax's)
    and 0 with zero gradients on the cuda tier (JAX's Pallas tier's)."""

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        mask: torch.Tensor,
        scale: float = 1.0,
        enable_gqa: bool = False,
    ) -> torch.Tensor:
        sdpa = MojoSdpa.get_backend_impl("ref")(scale=scale, enable_gqa=enable_gqa)
        return sdpa(query, key, value, attn_mask=mask)


def mojo_diffusion_attention(query, key, value, mask, scale: float = 1.0, enable_gqa: bool = False) -> torch.Tensor:
    """Functional form: ``MojoDiffusionAttentionFunction`` of the selected tier."""
    return MojoDiffusionAttentionFunction()(query, key, value, mask, scale, enable_gqa)


def block_diffusion_mask(seq_len: int, block_size: int, dtype: torch.dtype = torch.bool,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """Block-diffusion keep-mask (S, S): token i attends to every token of
    its own block (bidirectional) and to all tokens of earlier blocks."""
    blocks = torch.arange(seq_len, device=device) // block_size
    return (blocks[:, None] >= blocks[None, :]).to(dtype)
