"""Embedding lookups (counterpart of the JAX package's
``core/operators/embedding.py``: ``MojoEmbedding`` :27,
``MojoParallelEmbedding`` :74)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.runtime import comm_context
from mojo_opset_tpu_torch.utils.platform import resolve_device


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
            torch.empty((num_embeddings, embedding_dim), device=resolve_device(device),
                        dtype=dtype or torch.float32),
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


class MojoParallelEmbedding(MojoOperator):
    """Vocabulary-parallel embedding: shard ``shard`` of ``num_shards`` holds
    rows ``[shard * L, (shard + 1) * L)`` of the table, ``L = ceil(
    num_embeddings / num_shards)`` (the last shard's rows past the vocabulary
    stay zero). An index outside the local range looks up a zero row, and a
    sum over ``group`` assembles the full lookup, exactly: every index has
    one nonzero row over the ranks. ``group=None`` with one shard is the
    plain lookup; with ``group`` the shard count and index are the group's.

    In training the sum is Megatron's *g* (``comm_context.sum_over_group``:
    the identity backward), so the shard's rows get their gradient.

    ``gather_logits`` is the tied LM head's other half: ``hidden @
    weight.T`` gives this shard's logit columns, gathered here over the
    ranks and cut to the vocabulary. A vocab-parallel loss reads
    ``vocab_rows`` instead: the shard's rows inside the vocabulary, so the
    zero rows past it add nothing to a log-sum-exp."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        padding_idx: Optional[int] = None,
        *,
        group=None,
        num_shards: int = 1,
        shard: int = 0,
        device=None,
        dtype=None,
    ):
        super().__init__()
        if group is not None:
            num_shards, shard = comm_context.group_size(group), comm_context.group_rank(group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.group = group
        self.num_shards = num_shards
        self.shard = shard
        self.local_num_embeddings = math.ceil(num_embeddings / num_shards)
        self.vocab_start = shard * self.local_num_embeddings
        self.weight = nn.Parameter(
            torch.empty((self.local_num_embeddings, embedding_dim), device=resolve_device(device),
                        dtype=dtype or torch.float32),
            requires_grad=False,
        )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.normal_(0.0, 1.0, generator=generator)
        rows = torch.arange(self.local_num_embeddings, device=self.weight.device) + self.vocab_start
        self.weight[rows >= self.num_embeddings] = 0.0
        if self.padding_idx is not None and 0 <= self.padding_idx - self.vocab_start < self.local_num_embeddings:
            self.weight[self.padding_idx - self.vocab_start] = 0.0

    @classmethod
    def from_embedding(cls, embedding: MojoEmbedding, group=None, num_shards: int = 1, shard: int = 0
                       ) -> "MojoParallelEmbedding":
        """This rank's shard of a full table (on the table's device and dtype)."""
        w = embedding.weight
        out = cls(embedding.num_embeddings, embedding.embedding_dim, embedding.padding_idx, group=group,
                  num_shards=num_shards, shard=shard, device="meta", dtype=w.dtype)
        local = torch.zeros((out.local_num_embeddings, w.shape[1]), dtype=w.dtype, device=w.device)
        rows = w[out.vocab_start:out.vocab_start + out.local_num_embeddings]
        local[:rows.shape[0]] = rows
        out.weight = nn.Parameter(local, requires_grad=w.requires_grad)
        return out

    @property
    def num_vocab_rows(self) -> int:
        """The shard's rows inside the vocabulary (the last shard of an uneven split holds fewer)."""
        return max(0, min(self.local_num_embeddings, self.num_embeddings - self.vocab_start))

    @property
    def vocab_rows(self) -> torch.Tensor:
        """The shard's first ``num_vocab_rows`` rows: a view of the weight, gradients flow to it."""
        return self.weight[:self.num_vocab_rows]

    def forward(self, input: torch.Tensor) -> torch.Tensor:
        if self.group is None and self.num_shards == 1:
            return self.weight[input]
        local = input - self.vocab_start
        in_range = (local >= 0) & (local < self.local_num_embeddings)
        rows = self.weight[local.clamp(0, self.local_num_embeddings - 1)]
        rows = torch.where(in_range[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return comm_context.sum_over_group(rows, self.group)

    def gather_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """This shard's logit columns (``hidden @ weight.T``) gathered over the ranks, cut to the vocabulary."""
        return comm_context.all_gather(logits, self.group, dim=-1)[..., :self.num_embeddings]

    def extra_repr(self) -> str:
        return (f"num_embeddings={self.num_embeddings}, embedding_dim={self.embedding_dim}, "
                f"num_shards={self.num_shards}, shard={self.shard}")
