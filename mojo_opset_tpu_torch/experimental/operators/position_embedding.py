"""Experimental position embedding: the Wan DiT's 3-D grid RoPE.

Counterpart of the JAX package's ``experimental/operators/position_embedding.py``
(``MojoGridRoPE`` :76). ``MojoRelativeEmbedding`` (:21, the T5 buckets) and
``MojoMRoPEInplace`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator


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
