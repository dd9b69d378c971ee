"""cuda-tier MoE: the grouped SwiGLU experts on kernel H
(``csrc/group_gemm.cu``), counterpart of the JAX package's
``backends/pallas/operators/moe.py``.

``CudaExperts`` runs the fc1 GMM on the ``(E, 2I, H)`` weights as stored
(``trans_weight``, never transposed), SwiGLU in fp32 in PyTorch on fc1
rounded to the input dtype, as the Pallas tier does (:52-53), and the down
GMM. The Pallas tier's geometry limits (``_gmm_ok``, ``_pick_bk``: M % 8,
M >= 24, K % 128, N % 256) and its ``ragged_dot`` detour are TPU matters;
16-bit widths that are not whole 16-byte rows (hidden or intermediate %
8 != 0), which kernel H does not take, go to the golden experts, counted
in ``golden_calls``. ``CudaMoE`` exists so that a
``cuda`` MoE builds its sub-ops in this tier: the experts here, the golden
gating, dispatch and combine, none of which reads back to the host.
"""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.group_gemm import grouped_matmul
from mojo_opset_tpu_torch.backends.cuda.operators.gemm import group_gemm_takes
from mojo_opset_tpu_torch.core.operators.moe import MojoExperts, MojoMoE, swiglu


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
