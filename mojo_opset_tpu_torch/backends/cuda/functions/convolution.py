"""cuda-tier training causal conv1d: kernel Q (``csrc/conv1d.cu``) forward
and backward under one ``torch.autograd.Function``.

Counterpart of the JAX package's ``backends/pallas/functions/convolution.py:23``
(``PallasCausalConv1dFunction`` over ``conv1d_train``'s ``jax.custom_vjp``,
``conv1d_vjp.py:212-270``). The state enters as (B, W-1, D) rows in x's
dtype (zeros when none is given); the forward saves x, the weight, the bias
and the state, and the backward recomputes z. dw comes back in the weight's
dtype, db in the bias's; dstate is computed in torch ops over the
(B, <= W-1, D) sliver of outputs that read the state, as JAX does outside
its kernel. The residual add and the final-state slice stay outside the
autograd Function, as plain autograd. A ``cu_seqlens`` call takes the
golden, as JAX's tier does (:43), counted in ``golden_calls``. The TPU
tier's ``D % 128`` and ``W + 1 <= 16`` gates are TPU layout limits and are
not carried over (Q takes any D and W <= 16, and raises above); JAX's
``dispatch_default = False`` was set from a TPU measurement, and this is
the default tier.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.backends.cuda.kernels.conv1d_vjp import conv1d_bwd, conv1d_fwd, conv_z
from mojo_opset_tpu_torch.backends.cuda.kernels.silu_vjp import silu_bwd_plain
from mojo_opset_tpu_torch.core.functions.convolution import MojoCausalConv1dFunction
from mojo_opset_tpu_torch.core.operators.convolution import ACTIVATIONS


def state_grad(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], state: torch.Tensor,
               g: torch.Tensor, act: bool) -> torch.Tensor:
    """The gradient of the (B, W-1, D) state rows: stream row s < W-1 feeds
    out[t] through tap s - t, for t in [max(0, s-W+1), min(s, T-1)]; dz of
    those first min(W-1, T) outputs is recomputed here (JAX
    ``conv1d_vjp.py:244-268``)."""
    W = weight.shape[1]
    if W == 1:
        return torch.zeros_like(state)
    n = min(W - 1, x.shape[1])
    k = weight.t().float()  # (W, D)
    dz = g[:, :n].float()
    if act:
        dz = silu_bwd_plain(conv_z(x[:, :n], weight, bias, state), dz)
    rows = []
    for s in range(W - 1):
        acc = torch.zeros_like(dz[:, 0])
        for t in range(max(0, s - W + 1), min(s + 1, n)):
            acc = acc + dz[:, t] * k[s - t]
        rows.append(acc)
    return torch.stack(rows, dim=1).to(state.dtype)


class Conv1dVJP(torch.autograd.Function):
    """``apply(x, weight, bias, state, act, fwd, bwd)``: ``fwd``/``bwd`` are
    kernel Q's wrappers (a plain twin passes their plain versions)."""

    @staticmethod
    def forward(ctx, x, weight, bias, state, act, fwd, bwd):
        x, state = x.contiguous(), state.contiguous()
        ctx.save_for_backward(x, weight, bias, state)
        ctx.act, ctx.bwd = act, bwd
        return fwd(x, weight.float().contiguous(), None if bias is None else bias.float().contiguous(), state, act)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, state = ctx.saved_tensors
        bias_f = None if bias is None else bias.float().contiguous()
        g = g.to(x.dtype).contiguous()
        dx, dw, db = ctx.bwd(x, weight.float().contiguous(), bias_f, state, g, ctx.act)
        dstate = state_grad(x, weight, bias, state, g, ctx.act) if ctx.needs_input_grad[3] else None
        return (dx, dw.t().to(weight.dtype), None if bias is None else db.to(bias.dtype), dstate,
                None, None, None)


class CudaCausalConv1dFunction(MojoCausalConv1dFunction):
    """``fwd`` and ``bwd`` are kernel Q's wrappers; a plain twin on the card
    sets them to ``conv1d_fwd_plain`` and ``conv1d_bwd_plain``.
    ``golden_calls`` counts the calls that took the golden (``cu_seqlens``)."""

    golden_calls = 0
    fwd = staticmethod(conv1d_fwd)
    bwd = staticmethod(conv1d_bwd)

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
        if cu_seqlens is not None:
            type(self).golden_calls += 1
            return super().forward(x, weight, bias, residual, initial_state, output_final_state, activation,
                                   cu_seqlens)
        if activation not in ACTIVATIONS:
            raise NotImplementedError("activation must be None, silu, or swish")
        if x.ndim != 3 or x.shape[-1] != weight.shape[0]:
            raise ValueError(f"x must be (B, T, D) with D = weight.shape[0] = {weight.shape[0]}, "
                             f"got {tuple(x.shape)}")
        B, _, D = x.shape
        W = weight.shape[1]
        if initial_state is not None:
            state = initial_state.transpose(1, 2).to(x.dtype)  # (B, W-1, D)
        else:
            state = x.new_zeros(B, W - 1, D)
        out = Conv1dVJP.apply(x, weight, bias, state, activation is not None, self.fwd, self.bwd)
        if residual is not None:
            out = out + residual
        final_state = None
        if output_final_state:  # the last W-1 stream rows, carrying older history for short chunks
            T, keep = x.shape[1], W - 1
            tail = torch.cat([state, x[:, T - min(keep, T):]], dim=1)
            final_state = tail[:, tail.shape[1] - keep:].transpose(1, 2).to(x.dtype)
        return out, final_state
