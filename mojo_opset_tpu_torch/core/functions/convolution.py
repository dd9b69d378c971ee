"""Training causal conv1d (counterpart of the JAX package's
``core/functions/convolution.py:19``).

``MojoCausalConv1dFunction`` maps x (B, T, D) to ``(out, final_state)``;
with ``cu_seqlens`` each packed sequence is convolved alone (a Python loop,
the golden route). Its ref tier is ``causal_conv1d`` under autograd; the
cuda tier (``CudaCausalConv1dFunction``) runs kernel Q forward and
backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.function import MojoFunction
from mojo_opset_tpu_torch.core.operators.convolution import causal_conv1d


class MojoCausalConv1dFunction(MojoFunction):
    def forward(
        self,
        x: torch.Tensor,
        weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        residual: Optional[torch.Tensor] = None,
        initial_state: Optional[torch.Tensor] = None,
        output_final_state: bool = False,
        activation: Optional[str] = None,
        cu_seqlens: Optional[torch.Tensor] = None,
    ):
        if cu_seqlens is None:
            return causal_conv1d(x, weight, bias, initial_state=initial_state,
                                 output_final_state=output_final_state, activation=activation, residual=residual)
        cu = [int(v) for v in cu_seqlens.tolist()]
        outs, states = [], []
        for i, (s, e) in enumerate(zip(cu[:-1], cu[1:])):
            o, st = causal_conv1d(
                x[:, s:e], weight, bias,
                initial_state=None if initial_state is None else initial_state[i:i + 1],
                output_final_state=output_final_state, activation=activation,
                residual=None if residual is None else residual[:, s:e],
            )
            outs.append(o)
            if output_final_state:
                states.append(st)
        out = torch.cat(outs, dim=1)
        return out, (torch.cat(states, dim=0) if output_final_state and states else None)
