"""Post-training w8a8 quantization for Seed-OSS serving.

Counterpart of the JAX package's ``modeling/seed_oss/quantize.py:27``
(``quantize_seed_oss``), on the port's Qwen3 helpers
(``modeling/qwen3/quantize.py``): per-output-channel absmax int8 weights
on every projection and the untied lm_head. The int8 GEMM takes no bias,
so each projection's floating-point bias moves to the attention's
``{q,k,v,o}_bias`` parameter. The embedding, the norms' weights and the
rotary table are shared with the source model; quantizing runs on the
weights' device, one projection at a time.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mojo_opset_tpu_torch.modeling.qwen3.quantize import quantize_linear_weight

from .modeling_seed_oss import SeedOssForCausalLM

ATTENTION = ("q", "k", "v", "o")
MLP = ("gate_proj", "up_proj", "down_proj")


@torch.no_grad()
def _quantize_into(dst, src) -> None:
    q, scale = quantize_linear_weight(src.weight)
    dst.weight = nn.Parameter(q, requires_grad=False)
    dst.weight_scale = nn.Parameter(scale, requires_grad=False)


@torch.no_grad()
def quantize_seed_oss(model: SeedOssForCausalLM) -> SeedOssForCausalLM:
    """Return the w8a8 twin of a float ``SeedOssForCausalLM`` (bf16 or fp32),
    on the source's device, in the tier ``MOJO_BACKEND`` selects now. The
    twin shares the embedding, norm weights, biases and rotary table with
    the source; the source's projection weights may be freed afterwards."""
    config = dataclasses.replace(model.seed_oss_config, quant="w8a8")
    # built on the meta device: every tensor is replaced below, so nothing is allocated twice
    qm = SeedOssForCausalLM(config, device="meta")
    qm.embed_tokens = model.embed_tokens
    qm.norm = model.norm
    qm.rotary_emb = model.rotary_emb
    if model.lm_head is not None:
        _quantize_into(qm.lm_head, model.lm_head)
    for dst, src in zip(qm.layers, model.layers):
        dst.input_layernorm.weight = src.input_layernorm.weight
        dst.post_attention_layernorm.weight = src.post_attention_layernorm.weight
        for name in ATTENTION:
            proj = getattr(src.self_attn, f"{name}_proj")
            _quantize_into(getattr(dst.self_attn, f"{name}_proj"), proj)
            if proj.bias is not None:
                setattr(dst.self_attn, f"{name}_bias", proj.bias)
        for name in MLP:
            _quantize_into(getattr(dst.mlp, name), getattr(src.mlp, name))
    left = [name for name, t in qm.state_dict().items() if t.is_meta]
    if left:
        raise RuntimeError(f"quantize_seed_oss left tensors unset: {left[:4]}")
    return qm
