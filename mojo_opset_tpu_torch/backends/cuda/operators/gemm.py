"""cuda-tier int8 and packed-int4 GEMMs (kernels F and G,
``csrc/int8_matmul.cu`` and ``csrc/int4_matmul.cu``).

Every shape goes to a kernel: none of the TPU tier's ``M < 64``,
``M % 8``, ``K % 128`` or ``N % 128`` detours to the golden, and no M
padding for int4 (``backends/pallas/operators/gemm.py:81-102`` there):
both kernels mask the ragged edge.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.int4_matmul import int4_scaled_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int8_matmul import int8_scaled_matmul
from mojo_opset_tpu_torch.core.operators.gemm import MojoQuantGemm


class CudaQuantGemm(MojoQuantGemm):
    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        if self.weight_dtype == "int4":
            return int4_scaled_matmul(input, self.weight, input_scale, self.weight_scale, self.output_dtype)
        return int8_scaled_matmul(
            input, self.weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)
