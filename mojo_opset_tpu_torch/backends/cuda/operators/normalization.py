"""cuda-tier RMSNorm (kernel A, ``csrc/rmsnorm.cu``), residual add +
RMSNorm (kernel P, ``csrc/rmsnorm.cu``) and RMSNorm + int8 quant (kernel E,
``csrc/rmsnorm_quant.cu``)."""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.norms import residual_add_rmsnorm, rmsnorm
from mojo_opset_tpu_torch.backends.cuda.kernels.rmsnorm_quant import rmsnorm_quant
from mojo_opset_tpu_torch.core.operators.normalization import MojoResidualAddRMSNorm, MojoRMSNorm, MojoRMSNormQuant


class CudaRMSNorm(MojoRMSNorm):
    """A weight in another dtype (the Wan DiT's bf16 cast) reaches A in fp32,
    as the golden reads it."""

    def forward(self, hidden_state: torch.Tensor) -> torch.Tensor:
        return rmsnorm(hidden_state, self.weight.float(), self.variance_epsilon)


class CudaResidualAddRMSNorm(MojoResidualAddRMSNorm):
    """Kernel P: the sum stays in fp32 through the norm (the golden rounds
    it to the inputs' dtype first). The residual is in hidden's dtype or
    float32; the weight reaches P in fp32."""

    def forward(self, hidden_state: torch.Tensor, residual: torch.Tensor):
        return residual_add_rmsnorm(hidden_state, residual, self.weight.float(), self.variance_epsilon, self.norm_pos)


class CudaRMSNormQuant(MojoRMSNormQuant):
    """``smooth_scale`` goes to the kernel too (the TPU tier sent it to the
    golden)."""

    def forward(self, hidden_state: torch.Tensor, smooth_scale: Optional[torch.Tensor] = None):
        return rmsnorm_quant(
            hidden_state, self.weight, self.variance_epsilon, smooth_scale, self.q_min, self.q_max)
