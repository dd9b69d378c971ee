"""cuda-tier MoE: the grouped SwiGLU experts on kernel H
(``csrc/group_gemm.cu``) and the quantized experts on kernel R
(``csrc/group_quant_gemm.cu``), counterparts of the JAX package's
``backends/pallas/operators/moe.py`` and ``backends/xla/operators/moe.py``
(``XlaQuantExperts`` :42, ``XlaQuantMoE`` :113).

``CudaExperts`` runs the fc1 GMM on the ``(E, 2I, H)`` weights as stored
(``trans_weight``, never transposed), SwiGLU in fp32 in PyTorch on fc1
rounded to the input dtype, as the Pallas tier does (:52-53), and the down
GMM. The Pallas tier's geometry limits (``_gmm_ok``, ``_pick_bk``: M % 8,
M >= 24, K % 128, N % 256) and its ``ragged_dot`` detour are TPU matters;
16-bit widths that are not whole 16-byte rows (hidden or intermediate %
8 != 0), which kernel H does not take, go to the golden experts, counted
in ``golden_calls``.

``CudaQuantExperts`` computes what the golden ``MojoQuantExperts`` does,
in its formulation, so the two agree on every int8 value: the per-expert
dynamic quant (plain PyTorch on the device), kernel R on the fc1 weights
with output in the input dtype, SwiGLU in fp32 unrounded (the golden's
:277-278; JAX's xla tier keeps fc1 in fp32 and rounds the activation
instead, :93-100), the down quant and kernel R again. No step reads the
counts to the host. Group-wise weight scales (``*_quant_group_size > 0``),
a depth R does not take (K % 16 != 0, or packed int4 past
``int4_matmul.MAX_K``) and output dtypes outside bf16/fp16/fp32 go to the
golden, counted in ``golden_calls``.

``CudaMoE`` and ``CudaQuantMoE`` exist so that a ``cuda`` MoE builds its
sub-ops in this tier: the experts here, the golden gating, dispatch and
combine, none of which reads back to the host.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.group_gemm import grouped_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.group_quant_gemm import grouped_quant_matmul
from mojo_opset_tpu_torch.backends.cuda.kernels.int4_matmul import MAX_K
from mojo_opset_tpu_torch.backends.cuda.operators.gemm import group_gemm_takes
from mojo_opset_tpu_torch.core.operators.gemm import QUANT_OUTPUT_DTYPES
from mojo_opset_tpu_torch.core.operators.moe import MojoExperts, MojoMoE, MojoQuantExperts, MojoQuantMoE, swiglu


class CudaExperts(MojoExperts):
    golden_calls = 0

    def forward(self, sorted_hidden_states: torch.Tensor, tokens_per_expert: torch.Tensor) -> torch.Tensor:
        dtype = sorted_hidden_states.dtype
        if not all(group_gemm_takes(dtype, w.shape[2], w.shape[1], True)
                   for w in (self.up_proj_weight, self.down_proj_weight)):
            CudaExperts.golden_calls += 1
            return super().forward(sorted_hidden_states, tokens_per_expert)
        group_sizes = tokens_per_expert.to(torch.int32)
        fc1 = grouped_matmul(sorted_hidden_states, self.up_proj_weight, group_sizes, trans_weight=True)
        act = swiglu(fc1.float()).to(sorted_hidden_states.dtype)
        return grouped_matmul(act, self.down_proj_weight, group_sizes, trans_weight=True)


class CudaMoE(MojoMoE):
    pass


def group_quant_gemm_takes(K: int, weight_dtype, quant_group_size: int) -> bool:
    """Whether kernel R takes a stage: per-channel scales, whole 16-byte
    rows of K, and for packed int4 K at most ``MAX_K``."""
    return quant_group_size <= 0 and K % 16 == 0 and (weight_dtype != "int4" or K <= MAX_K)


class CudaQuantExperts(MojoQuantExperts):
    """Both stages on kernel R; what R does not take
    (``group_quant_gemm_takes``, or an output dtype it does not write) goes
    to the golden, counted in ``golden_calls``."""

    golden_calls = 0

    def forward(self, sorted_hidden_states: torch.Tensor, tokens_per_expert: torch.Tensor) -> torch.Tensor:
        dtype = sorted_hidden_states.dtype
        if dtype not in QUANT_OUTPUT_DTYPES or not (
                group_quant_gemm_takes(self.hidden_size, self.up_weight_dtype, self.up_quant_group_size)
                and group_quant_gemm_takes(self.intermediate_size, self.down_weight_dtype,
                                           self.down_quant_group_size)):
            CudaQuantExperts.golden_calls += 1
            return super().forward(sorted_hidden_states, tokens_per_expert)
        group_sizes = tokens_per_expert.to(torch.int32)
        x_q, x_s = self.up_proj_quantize(sorted_hidden_states, tokens_per_expert)
        fc1 = grouped_quant_matmul(x_q, self.up_proj_weight, group_sizes, self.up_proj_weight_scale, x_s, dtype,
                                   int4=self.up_weight_dtype == "int4")
        y_q, y_s = self.down_proj_quantize(swiglu(fc1.float()), tokens_per_expert)
        return grouped_quant_matmul(y_q, self.down_proj_weight, group_sizes, self.down_proj_weight_scale, y_s, dtype,
                                    int4=self.down_weight_dtype == "int4")


class CudaQuantMoE(MojoQuantMoE):
    pass
