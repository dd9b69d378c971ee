"""Dense GEMM (counterpart of the JAX package's ``core/operators/gemm.py:23``).

The JAX package leaves the dense projections to XLA dots, so the port
leaves them to ``torch.matmul``: there is no kernel tier for this op.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoGemm(MojoOperator):
    """nn.Linear-alike: ``y = x @ W^T + b`` with weight stored ``(out, in)``,
    drawn from U(-1/sqrt(in), 1/sqrt(in)) like the JAX package."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        bias: bool = True,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        dtype = dtype or torch.float32
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), device=device, dtype=dtype), requires_grad=False
        )
        self.bias = (
            nn.Parameter(torch.empty((out_features,), device=device, dtype=dtype), requires_grad=False)
            if bias
            else None
        )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / (self.in_features**0.5)
        self.weight.uniform_(-bound, bound, generator=generator)
        if self.bias is not None:
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        # bf16/f16 matmuls accumulate in fp32 and round once, as the JAX
        # op's preferred_element_type=float32 + cast does
        out = torch.matmul(input, self.weight.t())
        if self.bias is not None:
            out = out + self.bias
        return out.to(input.dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, bias={self.bias is not None}"
