"""Post-training w8a8 and w4a8 quantization for Qwen3 and Qwen3-MoE serving.

Counterpart of the JAX package's ``modeling/qwen3/quantize.py``
(``quantize_linear_weight`` :28, ``quantize_qwen3`` :52, ``pack_int4`` :93,
``quantize_expert_weight`` :104, ``quantize_qwen3_moe`` :121): every projection weight
and the untied lm_head get a per-output-channel absmax scale, ``scale =
max(max|w|, 1e-8) / qmax`` and ``q = clamp(round(w / scale))`` (round half
to even). int8: qmax 127, clamp to [-127, 127]. int4 (w4a8, the
projections whose width is a multiple of 128): qmax 7, clamp to [-8, 7],
then ``pack_int4_rows``; the lm_head stays int8. The embedding, the norms
and the rotary table are shared with the source model. Quantizing runs on
the weights' device, one projection at a time, so a model held on the card
is converted there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import MojoGemm, MojoQuantGemm
from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows

from .modeling_qwen3 import Qwen3ForCausalLM
from .modeling_qwen3_moe import Qwen3MoeForCausalLM

PROJECTIONS = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"), "mlp": ("gate_proj", "up_proj", "down_proj")}


@torch.no_grad()
def quantize_linear_weight(weight: torch.Tensor, weight_dtype: str = "int8"):
    """(N, K) float weight -> (int8 (N, K), float32 scale (N,)), absmax per
    output channel; with ``weight_dtype="int4"`` the int8 tensor holds the
    packed int4 values, (N // 2, K)."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")
    w = weight.float()
    qmax = 7.0 if weight_dtype == "int4" else 127.0
    scale = w.abs().amax(dim=1).clamp(min=1e-8) / qmax
    q = torch.round(w / scale[:, None])
    if weight_dtype == "int4":
        return pack_int4_rows(q.clamp(-8, 7).to(torch.int8)), scale
    return q.clamp(-127, 127).to(torch.int8), scale


@torch.no_grad()
def _quantize_into(dst: MojoQuantGemm, src: MojoGemm) -> None:
    if src.bias is not None:
        raise NotImplementedError("quantized conversion does not support projection bias")
    q, scale = quantize_linear_weight(src.weight, "int4" if dst.weight_dtype == "int4" else "int8")  # src: (N, K)
    dst.weight = nn.Parameter(q, requires_grad=False)
    dst.weight_scale = nn.Parameter(scale, requires_grad=False)


@torch.no_grad()
def quantize_qwen3(
    model: Qwen3ForCausalLM, weight_dtype: str = "int8", *, quant_kv: Optional[bool] = None
) -> Qwen3ForCausalLM:
    """Return the w8a8 (or, with ``weight_dtype="int4"``, w4a8) twin of a
    float ``Qwen3ForCausalLM`` (bf16 or fp32), on the source's device, in
    the tier ``MOJO_BACKEND`` selects now. The twin shares the embedding,
    norm and rotary tensors with the source; the source's projection
    weights may be freed afterwards. ``quant_kv`` sets the twin's C8 cache
    (default: the source's setting), so a bf16 model serves as its own
    int8 + C8 source."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")
    config = dataclasses.replace(model.qwen3_config, quant="w4a8" if weight_dtype == "int4" else "w8a8")
    if quant_kv is not None:
        config = dataclasses.replace(config, quant_kv=quant_kv)
    # built on the meta device: every tensor is replaced below, so nothing
    # is allocated twice
    qm = Qwen3ForCausalLM(config, device="meta")
    qm.model.embed_tokens = model.model.embed_tokens
    qm.model.norm = model.model.norm
    qm.model.rotary_emb = model.model.rotary_emb
    if model.lm_head is not None:
        _quantize_into(qm.lm_head, model.lm_head)
    for dst, src in zip(qm.model.layers, model.model.layers):
        dst.input_layernorm.weight = src.input_layernorm.weight
        dst.post_attention_layernorm.weight = src.post_attention_layernorm.weight
        dst.self_attn.q_norm = src.self_attn.q_norm
        dst.self_attn.k_norm = src.self_attn.k_norm
        for block, names in PROJECTIONS.items():
            for name in names:
                _quantize_into(getattr(getattr(dst, block), name), getattr(getattr(src, block), name))
    check_filled(qm, "quantize_qwen3")
    return qm


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-8, 7]) of (..., N, K) two a
    byte along the output rows: packed row r holds row 2r in its low nibble
    and row 2r + 1 in its high nibble, (..., N // 2, K) int8. The inverse of
    ``core.operators.moe.unpack_int4``; the JAX package's layout, bit for bit."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even number of rows, got {q.shape[-2]}")
    u = q.to(torch.int8).view(torch.uint8) & 15
    return (u[..., 0::2, :] | (u[..., 1::2, :] << 4)).view(torch.int8)


EXPERT_CHUNK = 16  # experts converted at a time: bounds the fp32 temporaries at full width


@torch.no_grad()
def quantize_expert_weight(weight: torch.Tensor, weight_dtype: str = "int8"):
    """(E, N, K) float expert weights -> (int8 (E, N, K), fp32 scale (E, N)),
    absmax per expert and output channel; with ``weight_dtype="int4"``
    (qmax 7, clamp to [-8, 7]) the int8 tensor holds the packed values, (E,
    N // 2, K). Converted EXPERT_CHUNK experts at a time."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")
    int4 = weight_dtype == "int4"
    qmax = 7.0 if int4 else 127.0
    E, N, K = weight.shape
    out = torch.empty((E, N // 2 if int4 else N, K), dtype=torch.int8, device=weight.device)
    scale = torch.empty((E, N), dtype=torch.float32, device=weight.device)
    for e in range(0, E, EXPERT_CHUNK):
        w = weight[e:e + EXPERT_CHUNK].float()
        s = w.abs().amax(dim=2).clamp(min=1e-8) / qmax
        q = torch.round(w / s[:, :, None])
        out[e:e + EXPERT_CHUNK] = pack_int4(q.clamp(-8, 7).to(torch.int8)) if int4 else q.clamp(-127, 127)
        scale[e:e + EXPERT_CHUNK] = s
    return out, scale


def _share(dst: nn.Module, src: nn.Module) -> None:
    """``dst`` (a norm) takes ``src``'s weight tensor, keeping its own tier."""
    dst.weight = src.weight


@torch.no_grad()
def qwen3_moe_twin(model: Qwen3MoeForCausalLM, weight_dtype: str = "int8") -> Qwen3MoeForCausalLM:
    """The w8a8 (w4a8 with ``weight_dtype="int4"``) shell of a float
    ``Qwen3MoeForCausalLM``, in the tier ``MOJO_BACKEND`` selects now: built
    on the meta device, its embedding and rotary table shared with the
    source, its final norm's weight shared and its lm_head quantized (int8
    in both modes); the decoder layers are left to
    :func:`quantize_qwen3_moe_layer`."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8' or 'int4', got {weight_dtype!r}")
    config = dataclasses.replace(model.qwen3_config, quant="w4a8" if weight_dtype == "int4" else "w8a8")
    qm = Qwen3MoeForCausalLM(config, device="meta")
    qm.embed_tokens = model.embed_tokens
    qm.rotary_emb = model.rotary_emb
    _share(qm.norm, model.norm)
    if model.lm_head is not None:
        _quantize_into(qm.lm_head, model.lm_head)
    return qm


@torch.no_grad()
def quantize_qwen3_moe_layer(dst: nn.Module, src: nn.Module, weight_dtype: str = "int8") -> None:
    """Fill decoder layer ``dst`` of a twin from float layer ``src``: the
    attention projections quantized (packed int4 under w4a8 where ``dst``
    holds int4), the expert stacks by :func:`quantize_expert_weight`, the
    smooth scales ones, and the norms' and the gate's tensors shared."""
    _share(dst.input_layernorm, src.input_layernorm)
    _share(dst.post_attention_layernorm, src.post_attention_layernorm)
    _share(dst.self_attn.q_norm, src.self_attn.q_norm)
    _share(dst.self_attn.k_norm, src.self_attn.k_norm)
    for name in PROJECTIONS["self_attn"]:
        _quantize_into(getattr(dst.self_attn, name), getattr(src.self_attn, name))
    dst.mlp.gating.gate_weight = src.mlp.gating.gate_weight
    quantize_experts_into(dst.mlp.experts, src.mlp.experts, weight_dtype)


@torch.no_grad()
def quantize_experts_into(dst: nn.Module, src: nn.Module, weight_dtype: str = "int8") -> None:
    """A ``MojoQuantExperts`` from a float ``MojoExperts``: both stacks
    quantized, the smooth scales ones on the source's device."""
    for name in ("up_proj", "down_proj"):
        q, scale = quantize_expert_weight(getattr(src, f"{name}_weight"), weight_dtype)
        setattr(dst, f"{name}_weight", nn.Parameter(q, requires_grad=False))
        setattr(dst, f"{name}_weight_scale", nn.Parameter(scale, requires_grad=False))
        smooth = getattr(dst, f"{name}_quantize")
        smooth.inv_smooth_scale = nn.Parameter(torch.ones(smooth.inv_smooth_scale.shape, device=q.device),
                                               requires_grad=False)


def check_filled(model: nn.Module, name: str) -> None:
    """Raise if a converter left a tensor of ``model`` on the meta device."""
    left = [key for key, t in model.state_dict().items() if t.is_meta]
    if left:
        raise RuntimeError(f"{name} left tensors unset: {left[:4]}")


@torch.no_grad()
def quantize_qwen3_moe(model: Qwen3MoeForCausalLM, weight_dtype: str = "int8") -> Qwen3MoeForCausalLM:
    """Return the w8a8 (w4a8 with ``weight_dtype="int4"``) twin of a float
    ``Qwen3MoeForCausalLM`` on the source's device, in the tier
    ``MOJO_BACKEND`` selects now: attention projections and the lm_head
    through ``MojoQuantGemm``, the experts through ``MojoQuantExperts``, the
    gate, norms, embedding and rotary table shared (JAX :121)."""
    qm = qwen3_moe_twin(model, weight_dtype)
    for dst, src in zip(qm.layers, model.layers):
        quantize_qwen3_moe_layer(dst, src, weight_dtype)
    check_filled(qm, "quantize_qwen3_moe")
    return qm
