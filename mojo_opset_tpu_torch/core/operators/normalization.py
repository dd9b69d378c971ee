"""RMSNorm (counterpart of the JAX package's ``core/operators/normalization.py:90``).

Statistics in fp32, result cast back to the input dtype. The weight is
fp32, as the JAX op creates it.
"""

from __future__ import annotations

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """``(x * rsqrt(mean(x^2) + eps)) * w`` in fp32, cast to x's dtype."""
    xf = x.float()
    normed = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


class MojoRMSNorm(MojoOperator):
    def __init__(self, norm_size: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        self.norm_size = norm_size
        self.weight = nn.Parameter(
            torch.ones((norm_size,), device=device, dtype=dtype or torch.float32), requires_grad=False
        )
        self.variance_epsilon = eps

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        """RMSNorm over the last dim; same shape/dtype as input."""
        return rms_norm(hidden_state, self.weight, self.variance_epsilon)

    def extra_repr(self) -> str:
        return f"norm_size={self.norm_size}, variance_epsilon={self.variance_epsilon}"
