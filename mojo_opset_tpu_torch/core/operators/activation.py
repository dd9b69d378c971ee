"""Activations (counterpart of the JAX package's ``core/operators/activation.py:28``)."""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoSilu(MojoOperator):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise SiLU (x * sigmoid(x)); same shape/dtype as input."""
        return torch.nn.functional.silu(x)
