"""cuda-tier grouped, int8 and packed-int4 GEMMs (kernels H, F and G:
``csrc/group_gemm.cu``, ``csrc/int8_matmul.cu`` and ``csrc/int4_matmul.cu``).

Every shape goes to a kernel: none of the TPU tier's ``M < 64``,
``M % 8``, ``M < 24``, ``K % 128`` or ``N % 128`` detours to the golden or
to ``ragged_dot``, and no M padding for int4
(``backends/pallas/operators/gemm.py:38-46, :81-102`` there): the kernels
mask the ragged edge.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.group_gemm import grouped_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int4_matmul import int4_scaled_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int8_matmul import int8_scaled_matmul
from mojo_opset_tpu_torch.core.operators.gemm import MojoGroupGemm, MojoQuantGemm


class CudaGroupGemm(MojoGroupGemm):
    """Kernel H on the stored layout (``(G, N, K)`` with ``trans_weight``,
    never transposed); the counts stay on the device."""

    def forward(self, input: torch.Tensor, group_list: torch.Tensor) -> torch.Tensor:
        self._check(input, group_list)
        return grouped_matmul(input, self.weight, group_list.to(torch.int32), self.trans_weight)


class CudaQuantGemm(MojoQuantGemm):
    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        if self.weight_dtype == "int4":
            return int4_scaled_matmul(input, self.weight, input_scale, self.weight_scale, self.output_dtype)
        return int8_scaled_matmul(
            input, self.weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)
