"""Training attention (counterpart of the JAX package's
``core/functions/attention.py:20``).

``MojoSWAFunction`` is differentiable dense varlen sliding-window
attention. Its golden is ``MojoSWA``'s plain PyTorch math, so its backward
is autograd of that math; the cuda tier (``CudaSWAFunction``) runs kernel
J forward and backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operators.attention import MojoSWA


class MojoSWAFunction(MojoFunction):
    def __init__(
        self,
        is_causal: bool = True,
        gqa_layout: str = "AABB",
        global_window_size: Optional[int] = None,
        local_window_size: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        # the op of this function's own tier (ref -> RefSWA, cuda -> CudaSWA), as in JAX
        self.swa = MojoSWA.get_backend_impl(self._backend)(
            is_causal=is_causal,
            gqa_layout=gqa_layout,
            global_window_size=global_window_size,
            local_window_size=local_window_size,
        )

    def forward(
        self,
        query: torch.Tensor,
        key: torch.Tensor,
        value: torch.Tensor,
        cu_q_lens: torch.Tensor,
        cu_total_seq_lens: torch.Tensor,
        softmax_scale: Optional[float] = None,
    ) -> torch.Tensor:
        return self.swa(query, key, value, cu_q_lens, cu_total_seq_lens, softmax_scale)

    def extra_repr(self) -> str:
        return self.swa.extra_repr()
