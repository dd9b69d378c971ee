"""Training RMSNorm (counterpart of the JAX package's
``core/functions/normalization.py:17``).

``MojoRMSNormFunction`` is differentiable RMSNorm that takes the weight as
a call argument (the training path), unlike the parameter-holding
``MojoRMSNorm`` operator. Its golden is ``rms_norm`` under autograd: fp32
statistics, the result in x's dtype, the weight's gradient in the weight's
dtype (fp32, bf16 or fp16). The cuda tier (``CudaRMSNormFunction``) runs
kernel A forward and kernel K backward.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operators.normalization import rms_norm


class MojoRMSNormFunction(MojoFunction):
    def __init__(self, eps: float = 1e-6, **kwargs):
        super().__init__(**kwargs)
        self.eps = eps

    def forward(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, weight, self.eps)

    def extra_repr(self) -> str:
        return f"eps={self.eps}"
