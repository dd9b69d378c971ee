"""Post-training w8a8 quantization for DeepSeek-V3 serving.

Counterpart of the JAX package's ``modeling/deepseekv3/quantize.py``
(``_quantize_mlp`` :27, ``quantize_deepseek_v3`` :34): the attention's LoRA
projections, ``kv_a_proj_with_mqa``, ``o_proj``, the dense and shared MLPs
and the lm_head get int8 weights with a per-output-channel absmax scale
(``quantize_linear_weight``), the routed experts int8 stacks
(``quantize_expert_weight``); the MLA decompression weight (``kv_b_proj``,
fp32, one tensor under both MLA ops), every norm, the gate, the embedding
and the rotary table are shared with the source. :func:`quantize_deepseek_v3_layer`
converts one decoder layer, so a caller that cannot hold the source and its
twin at once converts layer by layer into the shell of
:func:`deepseek_v3_twin` and frees each source layer as it goes
(chip_smoke.py phase 9).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from mojo_opset_tpu_torch.modeling.qwen3.quantize import _quantize_into, _share, check_filled, quantize_experts_into

from .modeling_deepseek_v3 import DeepseekV3ForCausalLM


def _quantize_mlp(dst: nn.Module, src: nn.Module) -> None:
    for name in ("gate_proj", "up_proj", "down_proj"):
        _quantize_into(getattr(dst, name), getattr(src, name))


@torch.no_grad()
def deepseek_v3_twin(model: DeepseekV3ForCausalLM) -> DeepseekV3ForCausalLM:
    """The w8a8 shell of a float ``DeepseekV3ForCausalLM``, in the tier
    ``MOJO_BACKEND`` selects now: built on the meta device, its embedding
    and rotary table shared with the source, its final norm's weight shared
    and its lm_head quantized; the decoder layers are left to
    :func:`quantize_deepseek_v3_layer`."""
    qm = DeepseekV3ForCausalLM(dataclasses.replace(model._config, quant="w8a8"), device="meta")
    qm.model.embed_tokens = model.model.embed_tokens
    qm.model.rotary_emb = model.model.rotary_emb
    _share(qm.model.norm, model.model.norm)
    if model.lm_head is not None:
        _quantize_into(qm.lm_head, model.lm_head)
    return qm


@torch.no_grad()
def quantize_deepseek_v3_layer(dst: nn.Module, src: nn.Module) -> None:
    """Fill decoder layer ``dst`` of a w8a8 twin from float layer ``src``."""
    _share(dst.input_layernorm, src.input_layernorm)
    _share(dst.post_attention_layernorm, src.post_attention_layernorm)
    da, sa = dst.self_attn, src.self_attn
    if sa.q_lora_rank is None:
        _quantize_into(da.q_proj, sa.q_proj)
    else:
        _quantize_into(da.q_a_proj, sa.q_a_proj)
        _share(da.q_a_layernorm, sa.q_a_layernorm)
        _quantize_into(da.q_b_proj, sa.q_b_proj)
    _quantize_into(da.kv_a_proj_with_mqa, sa.kv_a_proj_with_mqa)
    _share(da.kv_a_layernorm, sa.kv_a_layernorm)
    _quantize_into(da.o_proj, sa.o_proj)
    da.attn_prefill.kv_b_proj = da.attn_decode.kv_b_proj = sa.attn_prefill.kv_b_proj  # stays fp32
    if hasattr(src.mlp, "routed_experts"):  # a MoE layer
        dst.mlp.routed_experts.gating.gate_weight = src.mlp.routed_experts.gating.gate_weight
        quantize_experts_into(dst.mlp.routed_experts.experts, src.mlp.routed_experts.experts)
        _quantize_mlp(dst.mlp.shared_experts, src.mlp.shared_experts)
    else:  # a dense layer
        _quantize_mlp(dst.mlp, src.mlp)


@torch.no_grad()
def quantize_deepseek_v3(model: DeepseekV3ForCausalLM) -> DeepseekV3ForCausalLM:
    """Return the w8a8 serving twin of a float ``DeepseekV3ForCausalLM`` on
    the source's device, in the tier ``MOJO_BACKEND`` selects now (JAX :34)."""
    qm = deepseek_v3_twin(model)
    for dst, src in zip(qm.model.layers, model.model.layers):
        quantize_deepseek_v3_layer(dst, src)
    check_filled(qm, "quantize_deepseek_v3")
    return qm
