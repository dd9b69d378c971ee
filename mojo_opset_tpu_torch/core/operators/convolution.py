"""Causal depthwise conv1d (counterpart of the JAX package's
``core/operators/convolution.py``: ``depthwise_conv1d`` :21,
``causal_conv1d`` :40, ``MojoCausalConv1dUpdateState`` :75).

The golden computes in fp32 through ``F.conv1d(groups=D)`` (a
cross-correlation, as ``lax.conv_general_dilated`` is). Layouts as in JAX:
x (B, T, D), weight (D, W), the conv state (B, D, W-1). The state update
is functional: the op returns ``(out, new_conv_state)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mojo_opset_tpu_torch.core.operator import MojoOperator

ACTIVATIONS = (None, "silu", "swish")


def depthwise_conv1d(x_bdt: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, D, T_padded) * weight (D, W) depthwise, no padding, in fp32."""
    out = F.conv1d(x_bdt.float(), weight.float()[:, None, :], groups=weight.shape[0])
    if bias is not None:
        out = out + bias.float()[None, :, None]
    return out


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    initial_state: Optional[torch.Tensor] = None,
    output_final_state: bool = False,
    activation: Optional[str] = None,
    residual: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, T, D) over ``initial_state`` (B, D, W-1) (zeros if None) ->
    ``(out (B, T, D) in x's dtype, final state (B, D, W-1) or None)``. The
    final state is the last W-1 columns of ``initial_state ++ x``: a chunk
    shorter than W-1 carries the older history."""
    if activation not in ACTIVATIONS:
        raise NotImplementedError("activation must be None, silu, or swish")
    dtype_in = x.dtype
    xt = x.transpose(1, 2)  # (B, D, T)
    W = weight.shape[1]
    T = xt.shape[-1]
    if initial_state is None:
        padded = F.pad(xt, (W - 1, 0))
    else:
        padded = torch.cat([initial_state.to(xt.dtype), xt], dim=-1)
    out = depthwise_conv1d(padded, weight, bias)[..., :T]
    final_state = padded[..., padded.shape[-1] - (W - 1):].to(dtype_in) if output_final_state else None
    if activation is not None:
        out = F.silu(out)
    out = out.transpose(1, 2).to(dtype_in)
    if residual is not None:
        out = out + residual
    return out, final_state


class MojoCausalConv1dUpdateState(MojoOperator):
    """Causal conv over ``conv_state ++ hidden_states`` (B, D, *), computed
    in the weight's dtype; returns ``(out (B, D, T), new conv state)``, the
    functional form of the reference's in-place ``conv_state.copy_``."""

    def forward(
        self,
        hidden_states: torch.Tensor,
        conv_state: torch.Tensor,
        weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        activation: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        T = hidden_states.shape[-1]
        state_len = conv_state.shape[-1]
        combined = torch.cat([conv_state, hidden_states], dim=-1).to(weight.dtype)
        new_state = combined[:, :, -state_len:]
        out = depthwise_conv1d(combined, weight, bias)[..., -T:]
        if activation in ("silu", "swish"):
            out = F.silu(out)
        return out.to(hidden_states.dtype), new_state.to(conv_state.dtype)
