"""cuda-tier grouped, int8 and packed-int4 GEMMs (kernels H, F and G:
``csrc/group_gemm.cu``, ``csrc/int8_matmul.cu`` and ``csrc/int4_matmul.cu``).

The kernels mask the ragged edge: none of the TPU tier's ``M < 64``,
``M % 8``, ``M < 24`` or ``N % 128`` detours to the golden or to
``ragged_dot``, and no M padding for int4
(``backends/pallas/operators/gemm.py:38-46, :81-102`` there). What the
kernels cannot take goes to the golden, counted in the class's
``golden_calls``: ``CudaQuantGemm`` at ``K % 16 != 0`` (a TMA row stride
and the decode tile's 16-byte loads need whole 16-byte rows of K) and, for
int4, at ``K > int4_matmul.MAX_K`` (the int32 sums of 16 x the products);
``CudaGroupGemm`` with 16-bit inputs at ``K % 8 != 0``, or ``N % 8 != 0``
with a (G, K, N) weight (whole 16-byte rows), as JAX's tier sends its own
misfits to the golden or ``ragged_dot`` (:39, :81-102).
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.group_gemm import grouped_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int4_matmul import MAX_K, int4_scaled_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int8_matmul import int8_scaled_matmul
from mojo_opset_tpu_torch.core.operators.gemm import MojoGroupGemm, MojoQuantGemm


def group_gemm_takes(dtype: torch.dtype, K: int, N: int, trans_weight: bool) -> bool:
    """Whether kernel H takes the shape: fp32 any; 16-bit inputs whole
    16-byte rows of K, and of N with a (G, K, N) weight."""
    return dtype == torch.float32 or (K % 8 == 0 and (trans_weight or N % 8 == 0))


class CudaGroupGemm(MojoGroupGemm):
    """Kernel H on the stored layout (``(G, N, K)`` with ``trans_weight``,
    never transposed); the counts stay on the device. A shape H does not
    take (``group_gemm_takes``) goes to the golden, counted in
    ``golden_calls``."""

    golden_calls = 0

    def forward(self, input: torch.Tensor, group_list: torch.Tensor) -> torch.Tensor:
        self._check(input, group_list)
        K, N = input.shape[1], self.weight.shape[1 if self.trans_weight else 2]
        if not group_gemm_takes(input.dtype, K, N, self.trans_weight):
            CudaGroupGemm.golden_calls += 1
            return super().forward(input, group_list)
        return grouped_matmul(input, self.weight, group_list.to(torch.int32), self.trans_weight)


def quant_gemm_takes(K: int, weight_dtype) -> bool:
    """Whether kernels F and G take the depth K: whole 16-byte rows, and
    for G at most ``MAX_K``."""
    return K % 16 == 0 and (weight_dtype != "int4" or K <= MAX_K)


class CudaQuantGemm(MojoQuantGemm):
    """Kernel G for int4 weights, F for int8; a depth they do not take
    (``quant_gemm_takes``) goes to the golden, counted in ``golden_calls``."""

    golden_calls = 0

    def forward(self, input: torch.Tensor, input_scale: torch.Tensor) -> torch.Tensor:
        if input.ndim != 2:
            raise ValueError(f"input must be 2D, got shape {tuple(input.shape)}.")
        if not quant_gemm_takes(input.shape[1], self.weight_dtype):
            CudaQuantGemm.golden_calls += 1
            return super().forward(input, input_scale)
        if self.weight_dtype == "int4":
            return int4_scaled_matmul(input, self.weight, input_scale, self.weight_scale, self.output_dtype)
        return int8_scaled_matmul(
            input, self.weight, input_scale, self.weight_scale, self.trans_weight, self.output_dtype)
