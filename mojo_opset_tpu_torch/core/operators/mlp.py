"""SwiGLU MLP block (counterpart of the JAX package's
``core/operators/mlp.py:18``): ``fc1`` to twice the hidden width, split,
``silu(a1) * a2``, ``fc2``. Plain: the two projections are ``MojoGemm``s
(``torch.matmul``), as JAX leaves them to XLA."""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.gemm import MojoGemm
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoSwiGLUMLP(MojoOperator):
    """Weights ``fc1.weight`` (2 * hidden, input) and ``fc2.weight``
    (output, hidden), no biases, drawn from ``generator`` on ``device`` (the
    card unless another is named, ``utils.platform.resolve_device``)."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.fc1 = MojoGemm(input_size, hidden_size * 2, bias=False, device=device, dtype=dtype)
        self.fc2 = MojoGemm(hidden_size, output_size, bias=False, device=device, dtype=dtype)
        if generator is not None:
            self.fc1.reset_parameters(generator)
            self.fc2.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a1, a2 = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(torch.nn.functional.silu(a1) * a2)

    def extra_repr(self) -> str:
        return (f"input_size={self.fc1.in_features}, output_size={self.fc2.out_features}, "
                f"hidden_size={self.fc2.in_features}")
