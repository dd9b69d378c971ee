"""cuda-tier RMSNorm (kernel A, ``csrc/rmsnorm.cu``) and RMSNorm + int8
quant (kernel E, ``csrc/rmsnorm_quant.cu``)."""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.norms import rmsnorm
from mojo_opset_tpu_torch.backends.cuda.kernels.rmsnorm_quant import rmsnorm_quant
from mojo_opset_tpu_torch.core.operators.normalization import MojoRMSNorm, MojoRMSNormQuant


class CudaRMSNorm(MojoRMSNorm):
    """A weight in another dtype (the Wan DiT's bf16 cast) reaches A in fp32,
    as the golden reads it."""

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        return rmsnorm(hidden_state, self.weight.float(), self.variance_epsilon)


class CudaRMSNormQuant(MojoRMSNormQuant):
    """``smooth_scale`` goes to the kernel too (the TPU tier sent it to the
    golden)."""

    def forward(self, hidden_state: torch.Tensor, smooth_scale: Optional[torch.Tensor] = None):
        return rmsnorm_quant(
            hidden_state, self.weight, self.variance_epsilon, smooth_scale, self.q_min, self.q_max)
