"""Training RoPE (counterpart of the JAX package's
``core/functions/position_embedding.py:18``).

``MojoApplyRoPEFunction`` rotates q and k, head-first (..., H, S, D) or
token-first (..., S, H, D), with cos/sin broadcast over the head axis. The
tables are positional and get no gradient: the golden detaches them (JAX
``stop_gradient``, :33-34), and the cuda tier (``CudaApplyRoPEFunction``,
kernel M forward and backward) returns none for them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operators.position_embedding import rotate_half


class MojoApplyRoPEFunction(MojoFunction):
    def forward(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        cos: torch.Tensor,
        sin: torch.Tensor,
        head_first: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        head_axis = -3 if head_first else -2
        cos, sin = cos.detach().unsqueeze(head_axis), sin.detach().unsqueeze(head_axis)
        q_rot = (q * cos + rotate_half(q) * sin).to(q.dtype)
        k_rot = (k * cos + rotate_half(k) * sin).to(k.dtype)
        return q_rot, k_rot
