"""cuda-tier ApplyRoPE: token-first (T, H, D) on kernel B
(``csrc/rope.cu``), head-first (B, H, S, D) or (H, T, D) on kernel M
(``csrc/rope_head_first.cu``), as the JAX tier sends the head-first layout
to ``rope_head_first`` (``backends/pallas/operators/position_embedding.py:41-57``).
Neither kernel takes partial-rope tables (``nope_dim > 0``): such a call
raises, it does not fall back to the golden.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.backends.cuda.functions.position_embedding import rotate_layout
from mojo_opset_tpu_torch.backends.cuda.kernels.rope import rope_token_first
from mojo_opset_tpu_torch.backends.cuda.kernels.rope_head_first import rope_head_first
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
            return rotate_layout(rope_head_first, q, k, cos, sin, head_first=True)
        return rope_token_first(q, k, cos, sin)
