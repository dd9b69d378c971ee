"""cuda-tier RMSNorm (kernel A, ``csrc/rmsnorm.cu``)."""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.norms import rmsnorm
from mojo_opset_tpu_torch.core.operators.normalization import MojoRMSNorm


class CudaRMSNorm(MojoRMSNorm):
    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        return rmsnorm(hidden_state, self.weight, self.variance_epsilon)
