"""Training SiLU (counterpart of the JAX package's
``core/functions/activation.py:15``): its golden is ``F.silu`` under
autograd; the cuda tier (``CudaSiluFunction``) runs kernel L forward and
backward."""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction


class MojoSiluFunction(MojoFunction):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.silu(x)
