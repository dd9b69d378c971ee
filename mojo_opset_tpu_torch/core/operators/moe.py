"""MoE operator chain: Gating -> Dispatch -> Experts -> Combine
(counterpart of the JAX package's ``core/operators/moe.py``: ``MojoMoEGating``
:40, ``count_expert_tokens`` :70, ``MojoMoEDispatch`` :75, ``MojoExperts``
:104, ``MojoMoECombine`` :305, ``_MoEBase._pipeline`` :328, ``MojoMoE`` :416).

Each stage is a core op with its own tiers; ``MojoMoE`` builds its sub-ops
in its own tier, so a ``cuda`` MoE runs the ``cuda`` experts and the golden
of the stages that have no kernel. The bucket-internal token order is not
part of the dispatch contract; the port sorts stably, as ``jnp.argsort``
does, so it equals the JAX package's.

Nothing but the golden experts reads a value back to the host: the counts
stay on the device (``scatter_add_``, not ``bincount``, which reads its
maximum back on a card), and combine sums each token's top-k rows in a
fixed order instead of with atomics, so a run repeats bit for bit.

Expert parallelism (``ep_size > 1``) waits for the distributed slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.platform import resolve_device


class MojoMoEGating(MojoOperator):
    """fp32 gate matmul -> softmax -> top-k -> renormalize; returns (int32
    indices, fp32 gates). ``gate_weight`` is fp32 ``(H, E)`` in every model
    dtype, drawn from N(0, 0.02) as in the JAX package."""

    def __init__(self, hidden_size: int, num_experts: int, top_k: int, *, device=None):
        super().__init__()
        self.gate_weight = nn.Parameter(torch.empty((hidden_size, num_experts), device=resolve_device(device)),
                                        requires_grad=False)
        self.top_k = top_k
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.gate_weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, hidden_states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = torch.matmul(hidden_states.float(), self.gate_weight)
        probs = torch.softmax(logits, dim=-1)
        top_k_probs, top_k_indices = torch.topk(probs, self.top_k, dim=-1)
        top_k_gates = top_k_probs / top_k_probs.sum(dim=-1, keepdim=True)
        return top_k_indices.to(torch.int32), top_k_gates

    def extra_repr(self) -> str:
        return f"hidden_size={self.gate_weight.shape[0]}, num_experts={self.gate_weight.shape[1]}, top_k={self.top_k}"


def count_expert_tokens(top_k_indices: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rows routed to each expert, int32 (E,), counted on the device."""
    flat = top_k_indices.reshape(-1).long()
    counts = torch.zeros((num_experts,), dtype=torch.int32, device=flat.device)
    return counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))


class MojoMoEDispatch(MojoOperator):
    """Sort token copies by expert id; returns (sorted_hidden,
    tokens_per_expert, sorted_gates, token_indices)."""

    def __init__(self, num_experts: int):
        super().__init__()
        self.num_experts = num_experts

    def forward(self, hidden_states: torch.Tensor, top_k_gates: torch.Tensor, top_k_indices: torch.Tensor):
        if top_k_gates.dtype != torch.float32 or top_k_indices.dtype != torch.int32:
            raise ValueError(f"dispatch takes float32 gates and int32 indices, got {top_k_gates.dtype} and "
                             f"{top_k_indices.dtype}")
        K = top_k_indices.shape[1]
        flat_indices = top_k_indices.reshape(-1)
        expert_sort = torch.argsort(flat_indices, stable=True)
        token_indices = (expert_sort // K).to(torch.int32)  # repeat(arange(T), K)[expert_sort]
        tokens_per_expert = count_expert_tokens(flat_indices, self.num_experts)
        sorted_gates = top_k_gates.reshape(-1, 1).index_select(0, expert_sort)
        sorted_hidden_states = hidden_states.index_select(0, token_indices)
        return sorted_hidden_states, tokens_per_expert, sorted_gates, token_indices


def swiglu(fc1: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` over the two halves of fc1's last dim."""
    gate, up = fc1.chunk(2, dim=-1)
    return torch.nn.functional.silu(gate) * up


class MojoExperts(MojoOperator):
    """Grouped SwiGLU FFN over the expert buckets.

    Weights ``up_proj_weight`` ``(E, 2I, H)`` and ``down_proj_weight``
    ``(E, H, I)``, drawn from U(+-1/sqrt(H)) and U(+-1/sqrt(I)). The golden
    is a per-expert loop over the counts read to the host, in fp32 from end
    to end, with one rounding to the input dtype.
    """

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int, activation: str = "swiglu",
                 *, device=None, dtype=None):
        super().__init__()
        if activation != "swiglu":
            raise NotImplementedError(f"MojoExperts: Activation {activation} is not supported.")
        self.activation = activation
        dtype = dtype or torch.float32
        device = resolve_device(device)
        self.up_proj_weight = nn.Parameter(
            torch.empty((num_experts, 2 * intermediate_size, hidden_size), device=device, dtype=dtype),
            requires_grad=False)
        self.down_proj_weight = nn.Parameter(
            torch.empty((num_experts, hidden_size, intermediate_size), device=device, dtype=dtype),
            requires_grad=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for w, fan_in in ((self.up_proj_weight, self.up_proj_weight.shape[2]),
                          (self.down_proj_weight, self.down_proj_weight.shape[2])):
            bound = 1.0 / math.sqrt(fan_in)
            w.uniform_(-bound, bound, generator=generator)

    def forward(self, sorted_hidden_states: torch.Tensor, tokens_per_expert: torch.Tensor) -> torch.Tensor:
        outs, start = [], 0
        for e, n in enumerate(tokens_per_expert.tolist()):
            if n == 0:
                continue
            x = sorted_hidden_states[start:start + n].float()
            act = swiglu(x @ self.up_proj_weight[e].float().t())
            outs.append(act @ self.down_proj_weight[e].float().t())
            start += n
        return torch.cat(outs).to(sorted_hidden_states.dtype)

    def extra_repr(self) -> str:
        E, I2, H = self.up_proj_weight.shape
        return f"num_experts={E}, hidden_size={H}, intermediate_size={I2 // 2}"


class MojoMoECombine(MojoOperator):
    """Gate-weighted sum of the expert outputs back into token order.

    ``token_indices`` come from :class:`MojoMoEDispatch`: every token of
    ``output_buffer`` owns ``rows / T`` of them. The rows are grouped by
    token with a stable sort and summed over that axis in fp32, in expert
    order: the JAX package's scatter-add (moe.py:322-324) up to the order
    of its fp32 sums, with no atomics.
    """

    def __init__(self, multiply_by_gates: bool = True):
        super().__init__()
        self.multiply_by_gates = multiply_by_gates

    def forward(self, output_buffer: torch.Tensor, expert_outputs: torch.Tensor, sorted_gates: torch.Tensor,
                token_indices: torch.Tensor) -> torch.Tensor:
        T, H = output_buffer.shape
        rows = token_indices.shape[0]
        if T == 0 or rows % T:
            raise ValueError(f"combine takes the dispatch's rows, a whole number per token: {rows} rows, {T} tokens")
        vals = expert_outputs.float()
        if self.multiply_by_gates:
            vals = vals * sorted_gates.float()
        by_token = torch.argsort(token_indices, stable=True)
        combined = vals.index_select(0, by_token).reshape(T, rows // T, H).sum(dim=1)
        return combined.to(expert_outputs.dtype)


class MojoMoE(MojoOperator):
    """The MoE block: gating, dispatch, experts and combine, each built in
    this op's tier. ``ep_size > 1`` (expert parallelism) is not ported yet."""

    def __init__(self, num_experts: int, top_k: int, hidden_size: int, intermediate_size: Optional[int] = None,
                 activation: str = "swiglu", ep_size: int = 1, *, device=None, dtype=None):
        super().__init__()
        if activation != "swiglu":
            raise NotImplementedError(f"MojoMoE: Activation {activation} is not supported.")
        if intermediate_size is None:
            raise ValueError("MojoMoE: intermediate_size must be provided.")
        if ep_size != 1:
            raise NotImplementedError("MojoMoE: expert parallelism (ep_size > 1) waits for the distributed slice "
                                      "(ROADMAP.md, queue 1 item 14)")
        self.num_experts = num_experts
        self.top_k = top_k
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.ep_size = ep_size
        tier = self._backend
        self.gating = MojoMoEGating.get_backend_impl(tier)(hidden_size, num_experts, top_k, device=device)
        self.dispatch = MojoMoEDispatch.get_backend_impl(tier)(num_experts)
        self.experts = MojoExperts.get_backend_impl(tier)(
            num_experts, hidden_size, intermediate_size, activation, device=device, dtype=dtype)
        self.combine = MojoMoECombine.get_backend_impl(tier)(multiply_by_gates=True)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        top_k_indices, top_k_gates = self.gating(hidden_states)
        sorted_hidden, tokens_per_expert, sorted_gates, token_indices = self.dispatch(
            hidden_states, top_k_gates, top_k_indices)
        expert_outputs = self.experts(sorted_hidden, tokens_per_expert)
        # the buffer gives combine its shape only: empty, so no fill is launched
        return self.combine(torch.empty_like(hidden_states), expert_outputs, sorted_gates, token_indices)

    def extra_repr(self) -> str:
        return (f"num_experts={self.num_experts}, top_k={self.top_k}, hidden_size={self.hidden_size}, "
                f"intermediate_size={self.intermediate_size}, ep_size={self.ep_size}")
