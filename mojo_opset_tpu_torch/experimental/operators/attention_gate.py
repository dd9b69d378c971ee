"""Gated attention output for dual-path (full + SWA) attention
(counterpart of the JAX package's ``experimental/operators/attention_gate.py``:
``MojoFusedAttnOutputGate`` :20): the two paths' gate weights are kept
apart, as a checkpoint holds them, and run as one GEMM, a sigmoid and a
broadcast multiply."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoFusedAttnOutputGate(MojoOperator):
    """``full_gate_weight`` (N_full, hidden), ``swa_gate_weight`` (N_swa,
    hidden) and, with ``bias``, their biases, drawn from U(+-1/sqrt(hidden))
    (``generator``) in ``dtype`` (fp32 by default) on ``device``: the card
    unless another is named."""

    def __init__(self, hidden_size: int, num_heads_full: int, num_heads_swa: int, head_dim: int, bias: bool = False,
                 *, device=None, dtype=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_heads_full <= 0 or num_heads_swa <= 0:
            raise ValueError("both paths need heads")
        self.hidden_size = hidden_size
        self.num_heads_full = num_heads_full
        self.num_heads_swa = num_heads_swa
        self.num_heads_total = num_heads_full + num_heads_swa
        self.head_dim = head_dim
        device, dtype = resolve_device(device), dtype or torch.float32

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)

        self.full_gate_weight = param(num_heads_full, hidden_size)
        self.swa_gate_weight = param(num_heads_swa, hidden_size)
        self.full_gate_bias = param(num_heads_full) if bias else None
        self.swa_gate_bias = param(num_heads_swa) if bias else None
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / (self.hidden_size**0.5)
        for p in self.parameters():
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, hidden_states: torch.Tensor, full_attn_output: torch.Tensor,
                swa_attn_output: torch.Tensor) -> torch.Tensor:
        """hidden (T, hidden); the paths' outputs (T, N, D) or (T, N * D) ->
        (T, (N_full + N_swa) * D), each head times sigmoid of its gate, in
        fp32, cast to the hidden states' dtype."""
        T = hidden_states.shape[0]
        full = full_attn_output.reshape(T, self.num_heads_full, self.head_dim)
        swa = swa_attn_output.reshape(T, self.num_heads_swa, self.head_dim)
        weight = torch.cat([self.full_gate_weight, self.swa_gate_weight], dim=0).float()
        gate = torch.matmul(hidden_states.float(), weight.t())
        if self.full_gate_bias is not None:
            gate = gate + torch.cat([self.full_gate_bias, self.swa_gate_bias]).float()
        gated = torch.cat([full, swa], dim=1).float() * torch.sigmoid(gate)[..., None]
        return gated.reshape(T, self.num_heads_total * self.head_dim).to(hidden_states.dtype)

    def extra_repr(self) -> str:
        return (f"hidden_size={self.hidden_size}, num_heads_full={self.num_heads_full}, "
                f"num_heads_swa={self.num_heads_swa}, head_dim={self.head_dim}, "
                f"bias={self.full_gate_bias is not None}")
