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

The toy ``MojoQwen3MoeBlock`` (JAX :55-121) chains the decomposed ops once:
embedding, a qkv ``MojoGemm``, ``MojoRMSNorm``, the dense causal
``MojoPrefillGQA``, ``MojoRMSNorm``, then gating, dispatch, one
``MojoGroupGemm`` as the experts and the combine. Its ``state_dict()`` keys
are the JAX block's: ``embedding.weight``, ``qkv_proj.{weight,bias}``,
``{pre,post}_norm.weight``, ``moe_gate.gate_weight`` and ``moe_gmm.weight``.
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
    MojoGroupGemm,
    MojoMoE,
    MojoMoECombine,
    MojoMoEDispatch,
    MojoMoEGating,
    MojoPrefillGQA,
    MojoQuantMoE,
    MojoRMSNorm,
    MojoRMSNormQuant,
    MojoRotaryEmbedding,
)
from mojo_opset_tpu_torch.modeling.qwen3.modeling_qwen3 import Qwen3Attention, Qwen3Config, _quant_gemm, tied_logits
from mojo_opset_tpu_torch.runtime.config import MojoConfig, sharded_config
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


class MojoQwen3MoeBlock(nn.Module):
    """The composed MoE block: ``forward(input_ids (B, S))`` -> (B, S,
    hidden). The qkv projection's output (3 x heads x head_dim wide) is
    normed whole, split into q, k and v, and attended causally as B
    sequences of S; the attention output is normed and routed to
    ``num_experts`` one-matrix experts (``MojoGroupGemm``, (E, heads x
    head_dim, hidden)), ``top_k`` a token. Weights in ``dtype`` (the norms
    and the gate fp32, as in the JAX block) on ``device`` (the card unless
    another is named), drawn from ``generator``: embedding N(0, 1), qkv
    U(+-1/sqrt(hidden)), gate N(0, 0.02), experts N(0, 1) / sqrt(heads x
    head_dim)."""

    def __init__(self, vocab_size: int = 10000, hidden_size: int = 4096, num_heads: int = 32, head_dim: int = 128,
                 num_experts: int = 8, top_k: int = 2, *, device=None, dtype=torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        width = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.embedding = MojoEmbedding(vocab_size, hidden_size, device=device, dtype=dtype)
        self.qkv_proj = MojoGemm(hidden_size, width * 3, bias=True, device=device, dtype=dtype)
        self.pre_norm = MojoRMSNorm(width * 3, device=device)
        self.attn = MojoPrefillGQA()
        self.post_norm = MojoRMSNorm(width, device=device)
        self.moe_gate = MojoMoEGating(width, num_experts, top_k, device=device)
        self.moe_dispatch = MojoMoEDispatch(num_experts)
        experts = torch.randn((num_experts, width, hidden_size), generator=generator, device=device)
        self.moe_gmm = MojoGroupGemm((experts * width**-0.5).to(dtype))
        self.moe_combine = MojoMoECombine()
        for op in (self.embedding, self.qkv_proj, self.moe_gate):
            op.reset_parameters(generator=generator)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        B, S = input_ids.shape
        qkv = self.pre_norm(self.qkv_proj(self.embedding(input_ids)))
        q, k, v = qkv.chunk(3, dim=-1)

        def heads(x):  # (B, S, H * D) -> (B, H, S, D)
            return x.reshape(B, S, self.num_heads, self.head_dim).transpose(1, 2)

        cu_q_lens = torch.arange(B + 1, dtype=torch.int32, device=input_ids.device) * S
        attn = self.attn(heads(q), heads(k), heads(v), cu_q_lens)  # (B, S, Hq, D)
        tokens = self.post_norm(attn.reshape(B, S, -1)).reshape(B * S, -1)
        indices, gates = self.moe_gate(tokens)
        sorted_hidden, tokens_per_expert, sorted_gates, token_indices = self.moe_dispatch(tokens, gates, indices)
        expert_out = self.moe_gmm(sorted_hidden, tokens_per_expert)
        out = self.moe_combine(torch.zeros((tokens.shape[0], expert_out.shape[-1]), dtype=expert_out.dtype,
                                           device=expert_out.device), expert_out, sorted_gates, token_indices)
        return out.reshape(B, S, -1)


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
        return sharded_config(self._config.to_mojo(), self)

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
            logits = tied_logits(hidden, self.embed_tokens)
        elif self.lm_head_quant is not None:
            logits = self.lm_head(*self.lm_head_quant(hidden))
        else:
            logits = self.lm_head(hidden)
        return logits.float()
