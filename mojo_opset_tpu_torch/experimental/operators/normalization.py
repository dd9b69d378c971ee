"""Experimental normalization: the Wan VAE's channel norm, the group
LayerNorm and the "in place" RMSNorms.

Counterpart of the JAX package's ``experimental/operators/normalization.py``
(``MojoGroupLayerNorm`` :19, ``MojoChannelRMSNorm`` :46,
``MojoRMSNormInplace`` :82, ``MojoGroupRMSNormInplace`` :99). The
``inplace`` flag is API parity, as in the JAX ops: the ops return new
tensors (fp32 statistics, cast back to each input's dtype) and write
nothing they are given.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.normalization import _layer_norm_f32, _norm_param, _rms_norm_f32
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoGroupLayerNorm(MojoOperator):
    """LayerNorm of each tensor of a list, group ``g`` with weight and bias
    row ``g`` ((num_groups, norm_size): ones and zeros; none without
    ``elementwise_affine``)."""

    def __init__(self, num_groups: int, norm_size: int, eps: float, elementwise_affine: bool = True, *,
                 device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.norm_size = norm_size
        self.elementwise_affine = elementwise_affine
        self.variance_epsilon = eps
        shape = (num_groups, norm_size)
        self.weight = _norm_param(shape, 1.0, device, dtype) if elementwise_affine else None
        self.bias = _norm_param(shape, 0.0, device, dtype) if elementwise_affine else None

    def forward(self, input_groups: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [_layer_norm_f32(input_groups[g], None if self.weight is None else self.weight[g],
                                None if self.bias is None else self.bias[g],
                                self.variance_epsilon).to(input_groups[g].dtype) for g in range(self.num_groups)]

    def extra_repr(self) -> str:
        return (f"num_groups={self.num_groups}, norm_size={self.norm_size}, "
                f"variance_epsilon={self.variance_epsilon}, elementwise_affine={self.elementwise_affine}")


class MojoRMSNormInplace(MojoOperator):
    def __init__(self, norm_size: int, eps: float = 1e-5, inplace: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.weight = _norm_param((norm_size,), 1.0, device, dtype)
        self.variance_epsilon = eps
        self.inplace = inplace

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        return _rms_norm_f32(hidden_state, self.weight, self.variance_epsilon).to(hidden_state.dtype)

    def extra_repr(self) -> str:
        return f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}"


class MojoGroupRMSNormInplace(MojoOperator):
    """RMSNorm of each tensor of a list, group ``g`` scaled by weight row
    ``g`` (none without ``elementwise_affine``)."""

    def __init__(self, num_groups: int, norm_size: int, eps: float, elementwise_affine: bool = True,
                 inplace: bool = False, *, device=None, dtype=None):
        super().__init__()
        self.num_groups = num_groups
        self.norm_size = norm_size
        self.elementwise_affine = elementwise_affine
        self.weight = _norm_param((num_groups, norm_size), 1.0, device, dtype) if elementwise_affine else None
        self.variance_epsilon = eps
        self.inplace = inplace

    def forward(self, input_groups: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [_rms_norm_f32(input_groups[g], None if self.weight is None else self.weight[g],
                              self.variance_epsilon).to(input_groups[g].dtype) for g in range(self.num_groups)]

    def extra_repr(self) -> str:
        return (f"num_groups={self.num_groups}, norm_size={self.norm_size}, "
                f"variance_epsilon={self.variance_epsilon}, elementwise_affine={self.elementwise_affine}")


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
