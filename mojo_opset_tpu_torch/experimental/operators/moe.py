"""Experimental MoE fusions (counterpart of the JAX package's
``experimental/operators/moe.py``: ``_block_dynamic_quant`` :22,
``MojoMoEInitRoutingDynamicQuant`` :33,
``MojoFusedSwiGLUMoEScaleDynamicQuantize`` :109).

Golden ops in plain PyTorch: the JAX package has no kernel for them and no
model calls them. Rounding is ``torch.round`` (half to even, as
``jnp.round``), and each scale divides, as the JAX ops divide.
"""

from __future__ import annotations

from typing import Optional

import torch

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.core.operators.moe import count_expert_tokens
from mojo_opset_tpu_torch.core.operators.quantize import _require_int8, repeat_by_counts


def _block_dynamic_quant(x: torch.Tensor, quant_block_size: int):
    """Symmetric int8 quant of each run of ``quant_block_size`` values along
    the last dim: ``scale = max(amax, 1e-12) / 127`` a block. Returns
    ``(q of x's shape, scale (..., blocks))``."""
    if x.shape[-1] % quant_block_size != 0:
        raise ValueError(f"Last dim {x.shape[-1]} must be divisible by quant_block_size {quant_block_size}.")
    blocks = x.reshape(*x.shape[:-1], -1, quant_block_size)
    scale = blocks.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
    q = torch.round(blocks / scale[..., None]).clamp(-128, 127)
    return q.reshape(x.shape).to(torch.int8), scale


class MojoMoEInitRoutingDynamicQuant(MojoOperator):
    """Routing sort + optional per-expert smooth scale + block-wise dynamic
    int8 quant in one op. Returns (quantized (T, K, H), sorted_gates (T, K,
    1), sorted_token_indices (T, K, 1) int32, token_count (E,), scale (T, K,
    H / quant_block_size)): the T * K token copies sorted stably by expert,
    laid out (T, K) in that order."""

    def __init__(self, num_experts: int, top_k: int, quant_block_size: int = 8, quant_dtype=torch.int8,
                 start_expert_id: int = 0, end_expert_id: Optional[int] = None):
        super().__init__()
        _require_int8(quant_dtype)
        self.num_experts = num_experts
        self.top_k = top_k
        self.quant_block_size = quant_block_size
        self.quant_dtype = quant_dtype
        self.start_expert_id = start_expert_id
        self.end_expert_id = num_experts if end_expert_id is None else end_expert_id

    def forward(self, hidden_states: torch.Tensor, top_k_gates: torch.Tensor, top_k_indices: torch.Tensor,
                smooth_scale: Optional[torch.Tensor] = None, quant_mode: int = 0):
        if quant_mode not in (0, 1):
            raise NotImplementedError(f"Unsupported quant_mode: {quant_mode}, expected 0 or 1.")
        T, K = top_k_indices.shape
        H = hidden_states.shape[-1]
        flat_experts = top_k_indices.reshape(-1).to(torch.int64)
        order = torch.argsort(flat_experts, stable=True)
        token = order // K  # the token of each sorted copy: repeat(arange(T), K)[order]
        sorted_hidden = hidden_states.index_select(0, token).float()
        sorted_gates = top_k_gates.reshape(-1).index_select(0, order).float().reshape(T, K, 1)
        if smooth_scale is not None:
            if smooth_scale.ndim != 2 or smooth_scale.shape[0] != self.num_experts:
                raise ValueError("smooth_scale must be (num_experts, hidden_size), got "
                                 f"{tuple(smooth_scale.shape)} with num_experts={self.num_experts}")
            sorted_hidden = sorted_hidden * smooth_scale.float().index_select(0, flat_experts[order])
        quantized, scale = _block_dynamic_quant(sorted_hidden.reshape(T, K, H), self.quant_block_size)
        token_count = count_expert_tokens(top_k_indices, self.num_experts)
        return quantized, sorted_gates, token.to(torch.int32).reshape(T, K, 1), token_count, scale

    def extra_repr(self) -> str:
        return f"num_experts={self.num_experts}, top_k={self.top_k}, quant_block_size={self.quant_block_size}"


class MojoFusedSwiGLUMoEScaleDynamicQuantize(MojoOperator):
    """SwiGLU with ``beta`` (``silu(beta * left) / beta * right``), a smooth
    scale ((H,), or per expert (E, H) grouped by ``token_count``) and a
    per-route dynamic int8 quant: input (T, K, 2H) -> (q (T, K, H), scale
    (T, K)). Per-expert scales need the counts to cover the T * K routes,
    which the golden checks on the host, as the JAX op does."""

    def __init__(self, quant_dtype=torch.int8):
        super().__init__()
        _require_int8(quant_dtype)
        self.quant_dtype = quant_dtype

    def forward(self, input: torch.Tensor, smooth_scale: Optional[torch.Tensor], token_count: torch.Tensor,
                beta: float = 1.0, quant_mode: int = 0):
        if input.ndim != 3:
            raise ValueError(f"input must be 3D, got {tuple(input.shape)}")
        if input.shape[-1] % 2 != 0:
            raise ValueError(f"input last dim must be even for SwiGLU, got {input.shape[-1]}")
        if beta == 0:
            raise ValueError("beta must be non-zero.")
        if quant_mode not in (0, 1):
            raise NotImplementedError(f"Unsupported quant_mode: {quant_mode}, expected 0 or 1.")
        T, K, _ = input.shape
        left, right = input.float().chunk(2, dim=-1)
        output = torch.nn.functional.silu(left * beta) / beta * right
        if smooth_scale is not None:
            scale = smooth_scale.float()
            if scale.ndim == 1:
                output = output * scale
            else:
                counts = token_count.tolist()
                if len(counts) != scale.shape[0]:
                    raise ValueError(f"token_count has {len(counts)} entries for {scale.shape[0]} experts")
                if sum(counts) != T * K:
                    raise ValueError(f"token_count sums to {sum(counts)}, expected T*K={T * K}")
                output = output * repeat_by_counts(scale, token_count, T * K).reshape(T, K, -1)
        scale = output.abs().amax(dim=-1).clamp(min=1e-12) / 127.0
        q = torch.round(output / scale[..., None]).clamp(-128, 127)
        return q.to(self.quant_dtype), scale
