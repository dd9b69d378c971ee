"""Qwen3-MoE for paged serving.

Counterpart of the JAX package's ``modeling/qwen3/modeling_qwen3_moe.py``
(``Qwen3MoeConfig`` :41, ``Qwen3MoeDecoderLayer`` :123,
``Qwen3MoeForCausalLM`` :168): the dense Qwen3 with its MLP swapped for the
``MojoMoE`` chain (gating, dispatch, grouped SwiGLU experts, combine). Its
``forward`` and ``config`` are those of the dense model, so the session,
``FusedDecode``, ``MojoGenerator`` and the batchers take it unchanged.

As in the JAX model there is no ``model.`` level: ``state_dict()`` keys are
``embed_tokens.weight``, ``layers.N.mlp.gating.gate_weight`` (fp32 (H, E)),
``layers.N.mlp.experts.{up,down}_proj_weight`` ((E, 2I, H), (E, H, I)),
``layers.N.self_attn.*``, ``norm.weight`` and ``lm_head.weight``: those of
the JAX package's ``utils.hf.state_dict_of``.

Only bf16/fp16/fp32 serving is ported: the quantized experts (``quant=
"w8a8"``, ``"w4a8"``) come with ROADMAP.md queue 1, "Quantized MoE and
DeepSeek w8a8"; the toy ``MojoQwen3MoeBlock`` with "The rest of the
experimental ops".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import MojoEmbedding, MojoGemm, MojoMoE, MojoRMSNorm, MojoRotaryEmbedding
from mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3 import Qwen3Attention, Qwen3Config
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
        self.input_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = Qwen3Attention(c, device)
        self.post_attention_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.mlp = MojoMoE(num_experts=c.num_experts, top_k=c.num_experts_per_tok, hidden_size=c.hidden_size,
                           intermediate_size=c.moe_intermediate_size, device=device, dtype=c.dtype)

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
        if config.quant is not None:
            raise NotImplementedError(
                f"Qwen3-MoE quant={config.quant!r}: the quantized experts (MojoQuantMoE) are not ported yet "
                "(ROADMAP.md, queue 1, \"Quantized MoE and DeepSeek w8a8\")")
        device = resolve_device(device)
        self._config = config
        self.embed_tokens = MojoEmbedding(config.vocab_size, config.hidden_size, device=device, dtype=config.dtype)
        self.layers = nn.ModuleList(Qwen3MoeDecoderLayer(config, device) for _ in range(config.num_hidden_layers))
        self.norm = MojoRMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(config.rope_theta, config.head_dim, device=device)
        self.lm_head = None if config.tie_word_embeddings else MojoGemm(
            config.hidden_size, config.vocab_size, bias=False, device=device, dtype=config.dtype)
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
        else:
            logits = self.lm_head(hidden)
        return logits.float()
