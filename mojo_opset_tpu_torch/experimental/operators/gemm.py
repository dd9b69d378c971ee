"""Experimental GEMMs (counterpart of the JAX package's
``experimental/operators/gemm.py``: ``MojoQuantBatchGemmReduceSum`` :15)."""

from __future__ import annotations

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator


class MojoQuantBatchGemmReduceSum(MojoOperator):
    """int8 batch GEMM, scaled, summed over the batch: ``weight`` (B, K, N)
    int8, or (B, N, K) with ``trans_weight``; it stays on the device it
    comes on."""

    def __init__(self, weight: torch.Tensor, trans_weight: bool = False):
        super().__init__()
        if not isinstance(trans_weight, bool):
            raise TypeError("trans_weight must be bool.")
        self.trans_weight = trans_weight
        self.weight = nn.Parameter(weight, requires_grad=False)

    def forward(self, input: torch.Tensor, x1_scale: torch.Tensor, x2_scale: torch.Tensor) -> torch.Tensor:
        """(B, M, K) int8 x (B, K, N) int8 in fp32, times ``x2_scale`` (N,)
        or (B, N) (a scale a batch's weight column) and ``x1_scale`` (B, M),
        then summed over B one batch at a time in bf16, each batch's product
        rounded to bf16 before its add, as the JAX op does (:37-40) -> (M, N)
        bf16. The JAX op broadcasts (N,) alone, though its perf descriptor
        passes (B, N) (ROADMAP.md queue 3, "JAX-side notes")."""
        if input.ndim != 3 or self.weight.ndim != 3:
            raise ValueError(f"input and weight must be 3-D, got {tuple(input.shape)}, {tuple(self.weight.shape)}")
        weight = self.weight.transpose(1, 2) if self.trans_weight else self.weight
        b, m, k = input.shape
        if weight.shape[0] != b or weight.shape[1] != k:
            raise ValueError(f"weight {tuple(weight.shape)} does not match input {tuple(input.shape)}")
        out = torch.einsum("bmk,bkn->bmn", input.float(), weight.float())
        x2 = x2_scale.float()[:, None, :] if x2_scale.ndim == 2 else x2_scale.float()[None, None, :]
        out = out * x2 * x1_scale.float()[:, :, None]
        acc = torch.zeros((m, weight.shape[2]), dtype=torch.bfloat16, device=input.device)
        for i in range(b):
            acc = acc + out[i].to(torch.bfloat16)
        return acc

    def extra_repr(self) -> str:
        return f"weight_shape={tuple(self.weight.shape)}, trans_weight={self.trans_weight}"
