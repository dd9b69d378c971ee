"""cuda-tier ApplyRoPE (kernel B, ``csrc/rope.cu``).

Token-first (T, H, D) goes through the kernel; the head-first layout is
not on the serving path and stays on the plain golden.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.rope import rope_token_first
from mojo_opset_tpu_torch.core.operators.position_embedding import MojoApplyRoPE


class CudaApplyRoPE(MojoApplyRoPE):
    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        head_first: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if head_first:
            return super().forward(q, k, cos, sin, head_first=True)
        return rope_token_first(q, k, cos, sin)
