"""Activations (counterpart of the JAX package's ``core/operators/activation.py``:
``MojoGelu`` :15, ``MojoSilu`` :28). Plain ops: XLA computes them in JAX, so
PyTorch's own elementwise kernels do here."""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoGelu(MojoOperator):
    def __init__(self, approximate: bool = False):
        super().__init__()
        self.approximate = approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise GELU (tanh approximation with ``approximate``); same
        shape/dtype as input."""
        return torch.nn.functional.gelu(x, approximate="tanh" if self.approximate else "none")

    def extra_repr(self) -> str:
        return f"approximate={self.approximate}"


class MojoSilu(MojoOperator):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise SiLU (x * sigmoid(x)); same shape/dtype as input."""
        return torch.nn.functional.silu(x)
