"""Embedding lookup (counterpart of the JAX package's ``core/operators/embedding.py:27``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoEmbedding(MojoOperator):
    """Standard embedding lookup; weight ``(num_embeddings, embedding_dim)``
    drawn from N(0, 1) like the JAX package's ``utils/init.py::normal``."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        padding_idx: Optional[int] = None,
        *,
        device=None,
        dtype=None,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(
            torch.empty((num_embeddings, embedding_dim), device=device, dtype=dtype or torch.float32),
            requires_grad=False,
        )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        if self.padding_idx is not None:
            self.weight[self.padding_idx] = 0.0

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        return self.weight[input]

    def extra_repr(self) -> str:
        s = f"num_embeddings={self.num_embeddings}, embedding_dim={self.embedding_dim}"
        if self.padding_idx is not None:
            s += f", padding_idx={self.padding_idx}"
        return s
