"""Experimental normalization: the Wan VAE's channel norm.

Counterpart of the JAX package's ``experimental/operators/normalization.py``
(``MojoChannelRMSNorm`` :46). ``MojoGroupLayerNorm``, ``MojoRMSNormInplace``
and ``MojoGroupRMSNormInplace`` are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoChannelRMSNorm(MojoOperator):
    """Channel-axis L2 normalization scaled by sqrt(C) (the VAE's norm):
    ``x / max(||x||, 1e-12) * sqrt(C) * weight (+ bias)`` in fp32, cast back
    to x's dtype. ``channel_first`` takes NCHW / NCTHW, with a (C, 1, 1)
    weight for ``images`` and (C, 1, 1, 1) otherwise; channels-last takes a
    (C,) weight. The parameters are fp32 unless ``dtype`` says otherwise
    (ones, zeros for the bias) and lie on the card unless ``device`` names
    another. Plain PyTorch: XLA computes it in JAX."""

    def __init__(self, norm_size: int, channel_first: bool = True, images: bool = True, bias: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.channel_first = channel_first
        self.images = images
        self.has_bias = bias
        shape = (norm_size, *((1, 1) if images else (1, 1, 1))) if channel_first else (norm_size,)
        self.scale = norm_size**0.5
        device, dtype = resolve_device(device), dtype or torch.float32
        self.weight = nn.Parameter(torch.ones(shape, device=device, dtype=dtype), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype), requires_grad=False) if bias else None

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        xf = hidden_state.float()
        norm = torch.linalg.vector_norm(xf, dim=1 if self.channel_first else -1, keepdim=True)
        out = xf / norm.clamp_min(1e-12) * self.scale * self.weight.float()
        if self.bias is not None:
            out = out + self.bias.float()
        return out.to(hidden_state.dtype)

    def extra_repr(self) -> str:
        return (f"norm_size={self.norm_size}, channel_first={self.channel_first}, images={self.images}, "
                f"has_bias={self.has_bias}, scale={self.scale}")
