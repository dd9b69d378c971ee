"""Qwen3-MoE for paged serving.

Counterpart of the JAX package's ``modeling/qwen3/modeling_qwen3_moe.py``
(``Qwen3MoeConfig`` :41, ``Qwen3MoeDecoderLayer`` :123,
``Qwen3MoeForCausalLM`` :168): the dense Qwen3 with its MLP swapped for the
``MojoMoE`` chain (gating, dispatch, grouped SwiGLU experts, combine). Its
``forward`` and ``config`` are those of the dense model, so the session,
``FusedDecode``, ``MojoGenerator`` and the batchers take it unchanged.

Serving modes, as in the JAX model: ``quant="w8a8"`` and ``"w4a8"`` feed
the attention per-token int8 from ``MojoRMSNormQuant`` (its projections are
the dense model's: w4a8 packs int4 where the width is a multiple of 128),
keep the post-attention norm in fp (the MoE gate reads fp hidden states)
and run ``MojoQuantMoE``, whose experts quantize their own activations
(int8 weights, or packed int4 under w4a8); the lm_head is int8 behind a
``MojoDynamicQuant``. The quantized weights come from
``quantize_qwen3_moe`` or ``load_numpy_state``.

As in the JAX model there is no ``model.`` level: ``state_dict()`` keys are
``embed_tokens.weight``, ``layers.N.mlp.gating.gate_weight`` (fp32 (H, E)),
``layers.N.mlp.experts.{up,down}_proj_weight`` ((E, 2I, H), (E, H, I)),
``layers.N.self_attn.*``, ``norm.weight`` and ``lm_head.weight``: those of
the JAX package's ``utils.hf.state_dict_of``. The quantized modes add the
experts' ``{up,down}_proj_weight_scale`` and
``{up,down}_proj_quantize.inv_smooth_scale`` and the projections'
``weight_scale``.

The toy ``MojoQwen3MoeBlock`` waits for ROADMAP.md queue 1, "The rest of
the experimental ops".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import (
    MojoDynamicQuant,
    MojoEmbedding,
    MojoGemm,
    MojoMoE,
    MojoQuantMoE,
    MojoRMSNorm,
    MojoRMSNormQuant,
    MojoRotaryEmbedding,
)
from mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3 import Qwen3Attention, Qwen3Config, _quant_gemm
from mojo_opset_tpu_torch.runtime.config import MojoConfig
from mojo_opset_tpu_torch.utils.platform import resolve_device


@dataclass
class Qwen3MoeConfig(Qwen3Config):
    # Qwen3-30B-A3B's experts (huggingface.co/Qwen/Qwen3-30B-A3B, config.json)
    num_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768

    def to_mojo(self) -> MojoConfig:
        cfg = super().to_mojo()
        cfg.model_config.moe_expert_num = self.num_experts
        cfg.model_config.moe_topk = self.num_experts_per_tok
        cfg.model_config.moe_ffn_internal_dim = self.moe_intermediate_size
        return cfg


class Qwen3MoeDecoderLayer(nn.Module):
    def __init__(self, c: Qwen3MoeConfig, device=None):
        super().__init__()
        # the fused norm + quant feeds int8 into the attention; the MoE gate wants fp hidden states, so the
        # post-attention norm stays fp and MojoQuantMoE quantizes its experts' activations itself (JAX :126-131)
        norm = MojoRMSNorm if c.quant is None else MojoRMSNormQuant
        self.input_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = Qwen3Attention(c, device)
        self.post_attention_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        moe = dict(num_experts=c.num_experts, top_k=c.num_experts_per_tok, hidden_size=c.hidden_size,
                   intermediate_size=c.moe_intermediate_size, device=device)
        if c.quant is None:
            self.mlp = MojoMoE(**moe, dtype=c.dtype)
        else:
            weight_dtype = "int4" if c.quant == "w4a8" else torch.int8
            self.mlp = MojoQuantMoE(**moe, up_weight_dtype=weight_dtype, down_weight_dtype=weight_dtype)

    def forward(self, hidden, cos, sin, meta, caches, layer_idx):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin, meta, caches, layer_idx)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class Qwen3MoeForCausalLM(nn.Module):
    """Paged-generation Qwen3-MoE: ``forward(input_ids, positions, metadata,
    caches, lm_head_indices)`` returns fp32 logits and writes the step's K/V
    into ``caches``, as ``Qwen3ForCausalLM`` does. Built on the card unless
    ``device`` names another; ``generator`` draws the weights
    (``utils.weights.init_random_``)."""

    def __init__(self, config: Qwen3MoeConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self._config = config
        self.embed_tokens = MojoEmbedding(config.vocab_size, config.hidden_size, device=device, dtype=config.dtype)
        self.layers = nn.ModuleList(Qwen3MoeDecoderLayer(config, device) for _ in range(config.num_hidden_layers))
        self.norm = MojoRMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(config.rope_theta, config.head_dim, device=device)
        quant = config.quant is not None and not config.tie_word_embeddings
        self.lm_head_quant = MojoDynamicQuant() if quant else None
        if config.tie_word_embeddings:
            self.lm_head = None
        elif quant:  # int8 under w4a8 too, as in the JAX model (:205-209)
            self.lm_head = _quant_gemm(config, config.hidden_size, config.vocab_size, device, int4=False)
        else:
            self.lm_head = MojoGemm(config.hidden_size, config.vocab_size, bias=False, device=device,
                                    dtype=config.dtype)
        if generator is not None:
            from mojo_opset_tpu_torch.utils.weights import init_random_

            init_random_(self, generator)

    @property
    def config(self) -> MojoConfig:
        return self._config.to_mojo()

    @property
    def qwen3_config(self) -> Qwen3MoeConfig:
        return self._config

    def forward(self, input_ids, positions, meta, caches, lm_head_indices=None) -> torch.Tensor:
        hidden = self.embed_tokens(input_ids)
        cos, sin = self.rotary_emb(hidden, position_ids=positions)
        cos, sin = cos.to(hidden.dtype), sin.to(hidden.dtype)
        for layer_idx, layer in enumerate(self.layers):
            hidden = layer(hidden, cos, sin, meta, caches, layer_idx)
        hidden = self.norm(hidden)
        if lm_head_indices is not None:
            hidden = hidden[lm_head_indices]
        if self.lm_head is None:
            logits = torch.matmul(hidden, self.embed_tokens.weight.t())
        elif self.lm_head_quant is not None:
            logits = self.lm_head(*self.lm_head_quant(hidden))
        else:
            logits = self.lm_head(hidden)
        return logits.float()
