"""Experimental position embeddings: the T5 relative position bias, the
Wan DiT's 3-D grid RoPE and the "in place" MRoPE.

Counterpart of the JAX package's ``experimental/operators/position_embedding.py``
(``MojoRelativeEmbedding`` :21, ``MojoGridRoPE`` :76, ``MojoMRoPEInplace``
:103).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.position_embedding import MojoMRoPE
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoRelativeEmbedding(MojoOperator):
    """T5-style relative position bias: ``forward(lq, lk)`` returns the fp32
    (1, num_heads, Lq, Lk) rows of the (num_buckets, num_heads) ``embedding``
    (N(0, 1), fp32, on the card unless ``device`` names another) picked by
    each (query, key) distance's bucket. The bucket math is JAX's (:42-59):
    int32 distances, the log-spaced buckets in fp32, truncated toward zero."""

    def __init__(self, num_buckets: int, num_heads: int, bidirectional: bool, max_dist: int = 128, *,
                 device=None):
        super().__init__()
        if not isinstance(num_buckets, int) or num_buckets <= 0:
            raise ValueError("num_buckets must be a positive integer")
        if not isinstance(num_heads, int) or num_heads <= 0:
            raise ValueError("num_heads must be a positive integer")
        if not isinstance(bidirectional, bool):
            raise TypeError("bidirectional must be a bool")
        if not isinstance(max_dist, int) or max_dist <= 0:
            raise ValueError("max_dist must be a positive integer")
        self.num_buckets = num_buckets
        self.num_heads = num_heads
        self.bidirectional = bidirectional
        self.max_dist = max_dist
        self.embedding = nn.Parameter(torch.empty((num_buckets, num_heads), device=resolve_device(device),
                                                  dtype=torch.float32), requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.embedding.normal_(0.0, 1.0, generator=generator)

    def relative_position_bucket(self, rel_pos: torch.Tensor) -> torch.Tensor:
        """int32 ``key - query`` distances -> int32 buckets in [0, num_buckets)."""
        if self.bidirectional:
            num_buckets = self.num_buckets // 2
            rel_buckets = (rel_pos > 0).to(torch.int32) * num_buckets
            rel_pos = rel_pos.abs()
        else:
            num_buckets = self.num_buckets
            rel_buckets = torch.zeros_like(rel_pos)
            rel_pos = -rel_pos.clamp(max=0)
        max_exact = num_buckets // 2
        large = max_exact + (torch.log(rel_pos.clamp(min=1).float() / max_exact)
                             / math.log(self.max_dist / max_exact) * (num_buckets - max_exact)).to(torch.int32)
        large = large.clamp(max=num_buckets - 1)
        return rel_buckets + torch.where(rel_pos < max_exact, rel_pos, large)

    def forward(self, lq: int, lk: int) -> torch.Tensor:
        if not isinstance(lq, int) or not isinstance(lk, int) or lq <= 0 or lk <= 0:
            raise ValueError("lq and lk must be positive integers")
        device = self.embedding.device
        rel_pos = (torch.arange(lk, dtype=torch.int32, device=device)[None, :]
                   - torch.arange(lq, dtype=torch.int32, device=device)[:, None])
        emb = self.embedding[self.relative_position_bucket(rel_pos).long()]  # (Lq, Lk, H)
        return emb.permute(2, 0, 1)[None]

    def extra_repr(self) -> str:
        return (f"num_buckets={self.num_buckets}, num_heads={self.num_heads}, "
                f"bidirectional={self.bidirectional}, max_dist={self.max_dist}")


class MojoGridRoPE(MojoOperator):
    """3-D grid RoPE over (F, H, W) axes with precomputed complex phases.

    ``x`` (B, L, N, D) with D even, pairs ``(x[2i], x[2i + 1])`` taken as one
    complex number; ``grid_sizes`` is B rows of (F, H, W); ``freqs_list`` a
    length-B list of complex64 unit phases ``(F*H*W, 1, D/2)``. The rotation
    is computed in fp32 and cast back; tokens past F*H*W keep their values
    (the padding). The JAX op's contract, plain PyTorch (no kernel there).
    """

    def forward(self, x: torch.Tensor, grid_sizes: Sequence[Sequence[int]],
                freqs_list: List[torch.Tensor]) -> torch.Tensor:
        if x.ndim != 4 or x.shape[-1] % 2:
            raise ValueError(f"x must be (B, L, N, D) with D even, got {tuple(x.shape)}")
        grid = [tuple(int(v) for v in row) for row in grid_sizes]
        if len(grid) != x.shape[0] or any(len(row) != 3 for row in grid):
            raise ValueError(f"grid_sizes must be [B, 3] for B = {x.shape[0]}, got {grid}")
        _, _, N, D = x.shape
        outs = []
        for i, (f, h, w) in enumerate(grid):
            n = f * h * w
            xc = torch.view_as_complex(x[i, :n].float().reshape(n, N, D // 2, 2))
            rotated = torch.view_as_real(xc * freqs_list[i]).reshape(n, N, D)
            outs.append(torch.cat([rotated.to(x.dtype), x[i, n:]], dim=0))
        return torch.stack(outs)


class MojoMRoPEInplace(MojoOperator):
    """``MojoMRoPE`` with the ``inplace`` flag, which is API parity, as in
    the JAX op: the rotated q and k are new tensors."""

    def __init__(self, inplace: bool = False):
        super().__init__()
        self.inplace = inplace
        self.mrope = MojoMRoPE()

    def forward(self, query: torch.Tensor, key: torch.Tensor, cos_table: torch.Tensor, sin_table: torch.Tensor,
                mrope_section: List[int], is_interleaved: bool = False, head_dim: Optional[int] = None):
        return self.mrope(query, key, cos_table, sin_table, mrope_section, is_interleaved, head_dim)
