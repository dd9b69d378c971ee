"""MoE operator chain: Gating -> Dispatch -> Experts -> Combine
(counterpart of the JAX package's ``core/operators/moe.py``: ``MojoMoEGating``
:40, ``count_expert_tokens`` :70, ``MojoMoEDispatch`` :75, ``MojoExperts``
:104, ``unpack_int4`` :151, ``MojoQuantExperts`` :161, ``MojoMoECombine``
:305, ``_MoEBase._pipeline`` :328, ``MojoMoE`` :416, ``MojoQuantMoE`` :467).

Each stage is a core op with its own tiers; ``MojoMoE`` and
``MojoQuantMoE`` share one pipeline (``_MoEBase``) and build their sub-ops
in their own tier, so a ``cuda`` MoE runs the ``cuda`` experts and the
golden of the stages that have no kernel. The bucket-internal token order
is not part of the dispatch contract; the port sorts stably, as
``jnp.argsort`` does, so it equals the JAX package's.

Nothing but the golden experts reads a value back to the host: the counts
stay on the device (``scatter_add_``, not ``bincount``, which reads its
maximum back on a card), and combine sums each token's top-k rows in a
fixed order instead of with atomics, so a run repeats bit for bit.

The quantized experts (w8a8, w4a8) take int8 activations quantized per
token after per-expert smooth scales, and int8 weights (E, N, K) with fp32
per-channel scales (E, N), or packed int4 (E, N / 2, K) in
:func:`unpack_int4`'s layout: packed row r holds output rows 2r (low
nibble) and 2r + 1 (high nibble). This is not ``gemm.pack_int4_rows``'s
128-row blocked layout of the dense int4 projections.

Expert parallelism (``ep_size > 1``) waits for the distributed slice.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.quantize import MojoMoEDynamicQuant
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


def unpack_int4(weight: torch.Tensor) -> torch.Tensor:
    """The experts' packed int4 (..., N // 2, K) int8 -> (..., N, K) int8:
    packed row r gives row 2r from its low nibble and row 2r + 1 from its
    high nibble, each sign-extended from 4 bits (JAX :151)."""
    low = ((weight & 15) ^ 8) - 8
    high = weight >> 4  # arithmetic: the high nibble, sign-extended
    return torch.stack([low, high], dim=-2).reshape(*weight.shape[:-2], 2 * weight.shape[-2], weight.shape[-1])


def _int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` of int8 (n, K) and (N, K), summed in float64, which holds
    the int32 sums exactly (|sum| <= K * 128^2 < 2^53), then rounded once to
    fp32, as the JAX op's int32 -> fp32 cast rounds."""
    return torch.matmul(x.double(), w.double().t()).float()


def grouped_quant_matmul_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    group_sizes: torch.Tensor,
    weight_scale: torch.Tensor,
    x_scale: torch.Tensor,
    output_dtype: torch.dtype,
    int4: bool = False,
) -> torch.Tensor:
    """``out[r, n] = float(sum_k x[r, k] * W[g(r), n, k]) * weight_scale[g(r),
    n] * x_scale[r]``, multiplied in that order in fp32 and rounded once to
    ``output_dtype``: int8 ``x`` (M, K) with its rows sorted by group,
    ``weight`` int8 (G, N, K) or, with ``int4``, packed (G, N // 2, K),
    fp32 ``weight_scale`` (G, N) and ``x_scale`` (M, 1) or (M,).

    A per-group loop over the counts read to the host (a sync per call on
    a card). Rows past the groups' end are zero; a group that runs past row
    M is cut there."""
    w = unpack_int4(weight) if int4 else weight
    xs = x_scale.float().reshape(-1, 1)
    out = torch.zeros((x.shape[0], w.shape[1]), dtype=output_dtype, device=x.device)
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        stop = min(start + max(n, 0), x.shape[0])
        if stop > start:
            acc = _int_matmul(x[start:stop], w[g])
            out[start:stop] = (acc * weight_scale[g].float()[None, :] * xs[start:stop]).to(output_dtype)
        start = stop
    return out


class _MoEBase:
    """The pipeline shared by ``MojoMoE`` and ``MojoQuantMoE`` (JAX
    ``_MoEBase`` :328): gating, dispatch, the experts of ``experts_op``,
    combine, each built in the op's tier. A mixin, not an op."""

    def _build_chain(self, name: str, experts_op: type, num_experts: int, top_k: int, hidden_size: int,
                     intermediate_size: Optional[int], activation: str, ep_size: int, device, **experts_kwargs):
        if activation != "swiglu":
            raise NotImplementedError(f"{name}: Activation {activation} is not supported.")
        if intermediate_size is None:
            raise ValueError(f"{name}: intermediate_size must be provided.")
        if ep_size != 1:
            raise NotImplementedError(f"{name}: expert parallelism (ep_size > 1) waits for the distributed slice "
                                      "(ROADMAP.md, queue 1, \"Distributed\": expert parallelism)")
        self.num_experts = num_experts
        self.top_k = top_k
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.ep_size = ep_size
        tier = self._backend
        self.gating = MojoMoEGating.get_backend_impl(tier)(hidden_size, num_experts, top_k, device=device)
        self.dispatch = MojoMoEDispatch.get_backend_impl(tier)(num_experts)
        self.experts = experts_op.get_backend_impl(tier)(
            num_experts, hidden_size, intermediate_size, activation, device=device, **experts_kwargs)
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


class MojoMoE(_MoEBase, MojoOperator):
    """The MoE block: gating, dispatch, experts and combine, each built in
    this op's tier. ``ep_size > 1`` (expert parallelism) is not ported yet."""

    def __init__(self, num_experts: int, top_k: int, hidden_size: int, intermediate_size: Optional[int] = None,
                 activation: str = "swiglu", ep_size: int = 1, *, device=None, dtype=None):
        super().__init__()
        self._build_chain("MojoMoE", MojoExperts, num_experts, top_k, hidden_size, intermediate_size, activation,
                          ep_size, device, dtype=dtype)


WEIGHT_DTYPES = (torch.int8, "int4")


class MojoQuantExperts(MojoOperator):
    """w8a8 / w4a8 grouped SwiGLU experts.

    Per stage: ``MojoMoEDynamicQuant`` (``up_proj_quantize``,
    ``down_proj_quantize``: per-expert smooth scales, per-token int8), an
    int8 product with exact int32 sums dequantized by ``(acc *
    weight_scale) * x_scale``, output in the input dtype; fc1's output
    widened to fp32 feeds SwiGLU unrounded. Weights: ``up_proj_weight``
    int8 (E, 2I, H) or packed int4 (E, I, H), ``down_proj_weight`` (E, H,
    I) or (E, H / 2, I); scales fp32 (E, 2I) and (E, H), or (E, N, groups)
    with ``*_quant_group_size > 0`` (scales along K in groups of that
    size). The JAX op's scales default to bf16 ones, but its converter
    writes fp32 and a bf16 value widens exactly, so the port keeps fp32. A
    new op holds zeros and ones; ``quantize_qwen3_moe`` and
    ``load_numpy_state`` fill it. The golden is a per-expert loop over the
    counts read to the host, as in JAX (:261).
    """

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int, activation: str = "swiglu",
                 quant_dtype=torch.int8, up_quant_group_size: int = -1, up_weight_dtype=torch.int8,
                 down_quant_group_size: int = -1, down_weight_dtype=torch.int8, *, device=None):
        super().__init__()
        if activation != "swiglu":
            raise NotImplementedError(f"MojoQuantExperts: Activation {activation} is not supported.")
        if quant_dtype != torch.int8:
            raise ValueError(f"MojoQuantExperts: quant_dtype must be int8, got {quant_dtype}.")
        if up_weight_dtype not in WEIGHT_DTYPES or down_weight_dtype not in WEIGHT_DTYPES:
            raise NotImplementedError("MojoQuantExperts currently only supports w4 or w8.")
        self.activation = activation
        self.quant_dtype = quant_dtype
        self.up_weight_dtype, self.down_weight_dtype = up_weight_dtype, down_weight_dtype
        self.up_quant_group_size, self.down_quant_group_size = up_quant_group_size, down_quant_group_size
        self.num_experts, self.hidden_size, self.intermediate_size = num_experts, hidden_size, intermediate_size
        device = resolve_device(device)
        tier = self._backend
        self.up_proj_quantize = MojoMoEDynamicQuant.get_backend_impl(tier)(num_experts, hidden_size, device=device)
        self.down_proj_quantize = MojoMoEDynamicQuant.get_backend_impl(tier)(num_experts, intermediate_size,
                                                                             device=device)
        E, H, I = num_experts, hidden_size, intermediate_size
        up_rows = I if up_weight_dtype == "int4" else 2 * I
        down_rows = H // 2 if down_weight_dtype == "int4" else H

        def param(shape, fill, dtype=torch.float32):
            return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device), requires_grad=False)

        def scale_shape(n, k, group_size):
            return (E, n) if group_size <= 0 else (E, n, -(-k // group_size))

        self.up_proj_weight = param((E, up_rows, H), 0, torch.int8)
        self.down_proj_weight = param((E, down_rows, I), 0, torch.int8)
        self.up_proj_weight_scale = param(scale_shape(2 * I, H, up_quant_group_size), 1.0)
        self.down_proj_weight_scale = param(scale_shape(H, I, down_quant_group_size), 1.0)

    @staticmethod
    def _quant_linear(x_int8, x_scale, weight, weight_scale, output_dtype, weight_dtype, quant_group_size=-1):
        """One expert's int8 product and dequant (JAX :229): per channel
        ``(acc * weight_scale) * x_scale``; with K groups each group's sum
        times its scale and ``x_scale``, summed over the groups in fp32."""
        w = unpack_int4(weight) if weight_dtype == "int4" else weight
        xs, ws = x_scale.float(), weight_scale.float()
        if quant_group_size <= 0:
            return (_int_matmul(x_int8, w) * ws[None, :] * xs).to(output_dtype)
        K = x_int8.shape[-1]
        parts = [_int_matmul(x_int8[:, k:k + quant_group_size], w[:, k:k + quant_group_size])
                 for k in range(0, K, quant_group_size)]
        return (torch.stack(parts, dim=-1) * ws[None] * xs[..., None]).sum(-1).to(output_dtype)

    def forward(self, sorted_hidden_states: torch.Tensor, tokens_per_expert: torch.Tensor) -> torch.Tensor:
        dtype = sorted_hidden_states.dtype
        x_q, x_s = self.up_proj_quantize(sorted_hidden_states, tokens_per_expert)
        counts = tokens_per_expert.tolist()
        bounds = [0]
        for n in counts:
            bounds.append(bounds[-1] + n)
        experts = [(e, slice(bounds[e], bounds[e + 1])) for e in range(self.num_experts) if counts[e]]
        act = [swiglu(self._quant_linear(x_q[sl], x_s[sl], self.up_proj_weight[e], self.up_proj_weight_scale[e],
                                         dtype, self.up_weight_dtype, self.up_quant_group_size).float())
               for e, sl in experts]
        act = torch.cat(act) if act else x_q.new_zeros((0, self.intermediate_size), dtype=torch.float32)
        y_q, y_s = self.down_proj_quantize(act, tokens_per_expert)
        out = [self._quant_linear(y_q[sl], y_s[sl], self.down_proj_weight[e], self.down_proj_weight_scale[e], dtype,
                                  self.down_weight_dtype, self.down_quant_group_size) for e, sl in experts]
        return torch.cat(out) if out else x_q.new_zeros((0, self.hidden_size), dtype=dtype)

    def extra_repr(self) -> str:
        return (f"num_experts={self.num_experts}, intermediate_size={self.intermediate_size}, "
                f"hidden_size={self.hidden_size}, quant_dtype={self.quant_dtype}, "
                f"up_weight_dtype={self.up_weight_dtype}, down_weight_dtype={self.down_weight_dtype}")


class MojoQuantMoE(_MoEBase, MojoOperator):
    """The quantized MoE block: ``MojoMoE``'s pipeline with
    ``MojoQuantExperts`` (w8a8, or w4a8 with ``*_weight_dtype="int4"``).
    The gate stays fp32 on the fp hidden states."""

    def __init__(self, num_experts: int, top_k: int, hidden_size: int, intermediate_size: Optional[int] = None,
                 activation: str = "swiglu", quant_dtype=torch.int8, up_quant_group_size: int = -1,
                 up_weight_dtype=torch.int8, down_quant_group_size: int = -1, down_weight_dtype=torch.int8,
                 ep_size: int = 1, *, device=None):
        super().__init__()
        self._build_chain("MojoQuantMoE", MojoQuantExperts, num_experts, top_k, hidden_size, intermediate_size,
                          activation, ep_size, device, quant_dtype=quant_dtype,
                          up_quant_group_size=up_quant_group_size, up_weight_dtype=up_weight_dtype,
                          down_quant_group_size=down_quant_group_size, down_weight_dtype=down_weight_dtype)
