"""cuda-tier int8 GEMM (kernel F, ``csrc/int8_matmul.cu``).

Every shape goes to the kernel: none of the TPU tier's ``M < 64``,
``M % 8``, ``K % 128`` or ``N % 128`` detours to the golden
(``backends/pallas/operators/gemm.py:101-102`` there).
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.int8_matmul import int8_scaled_matmul
from mojo_opset_tpu_torch.core.operators.gemm import MojoQuantGemm


class CudaQuantGemm(MojoQuantGemm):
    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        return int8_scaled_matmul(
            input, self.weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)
