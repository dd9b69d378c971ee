"""Experimental activations (counterpart of the JAX package's
``experimental/operators/activation.py``: ``MojoRotateActivation`` :18, the
normalized Walsh-Hadamard rotation of DeepSeek-V3.2's indexer)."""

from __future__ import annotations

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.misc import hadamard


class MojoRotateActivation(MojoOperator):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The Hadamard transform over the last dim in fp32: zero-padded to
        the next power of two, scaled by ``dim ** -0.5`` of the unpadded
        dim, cut back to ``dim``; cast to x's dtype."""
        dim = x.shape[-1]
        padded = 1 << (dim - 1).bit_length()
        x2 = x.reshape(-1, dim).float()
        if padded != dim:
            x2 = torch.nn.functional.pad(x2, (0, padded - dim))
        out = torch.matmul(x2, hadamard(padded, torch.float32, x.device).t()) * (dim**-0.5)
        return out[:, :dim].reshape(x.shape).to(x.dtype)
