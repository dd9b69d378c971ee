"""Post-training w8a8 and w4a8 quantization for Qwen3 serving.

Counterpart of the JAX package's ``modeling/qwen3/quantize.py:28-90``
(``quantize_linear_weight``, ``quantize_qwen3``): every projection weight
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
    left = [name for name, t in qm.state_dict().items() if t.is_meta]
    if left:
        raise RuntimeError(f"quantize_qwen3 left tensors unset: {left[:4]}")
    return qm
