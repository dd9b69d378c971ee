"""Qwen3 dense model for paged serving.

Counterpart of the JAX package's ``modeling/qwen3/modeling_qwen3.py`` (dense,
``quant=None``, ``quant_kv=False``): packed varlen token layout (T, hidden)
for prefill and (B, hidden) for decode; the model writes the session's KV
caches in place and returns fp32 logits. It names only core ops, so the
tier (``MOJO_BACKEND``) is invisible to it. Attribute names follow the
JAX model, so ``state_dict()`` keys equal the JAX package's
``utils.hf.state_dict_of`` keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import (
    MojoApplyRoPE,
    MojoEmbedding,
    MojoGemm,
    MojoPagedDecodeGQA,
    MojoPagedPrefillGQA,
    MojoRMSNorm,
    MojoRotaryEmbedding,
    MojoSilu,
    MojoStorePagedKVCache,
)
from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig
from mojo_opset_tpu_torch.runtime.session import AttentionMetadata, KVCaches


@dataclass
class Qwen3Config:
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_hidden_layers: int = 32
    head_dim: int = 128
    vocab_size: int = 151936
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    kv_layout: str = "NHD"
    # the int8 serving modes of the JAX model ("w8a8"/"w4a8" weights, C8
    # KV cache) are not ported yet (ROADMAP.md queue 1 item 6)
    quant: Optional[str] = None
    quant_kv: bool = False

    def __post_init__(self):
        if self.quant is not None or self.quant_kv:
            raise NotImplementedError(
                "Qwen3 quant/quant_kv serving modes are not ported yet: they come with the int8 "
                "serving slice (ROADMAP.md queue 1 item 6, kernels norms.py::rmsnorm_quant and "
                "int8_matmul.py::int8_scaled_matmul)"
            )

    def to_mojo(self) -> MojoConfig:
        return MojoConfig(
            model_config=MojoModelConfig(
                model_name="qwen3",
                hidden_size=self.hidden_size,
                head_dim=self.head_dim,
                num_heads=self.num_attention_heads,
                num_kv_heads=self.num_key_value_heads,
                num_layers=self.num_hidden_layers,
                vocab_size=self.vocab_size,
                max_position_embeddings=self.max_position_embeddings,
                dtype=self.dtype,
                rope_theta=self.rope_theta,
                rms_norm_eps=self.rms_norm_eps,
                intermediate_size=self.intermediate_size,
                tie_word_embeddings=self.tie_word_embeddings,
                kv_layout=self.kv_layout,
            )
        )


class Qwen3Attention(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.num_heads = H
        self.num_kv_heads = Hkv
        self.head_dim = D
        f = dict(device=device, dtype=c.dtype)
        self.q_proj = MojoGemm(c.hidden_size, H * D, bias=c.attention_bias, **f)
        self.k_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
        self.v_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
        self.o_proj = MojoGemm(H * D, c.hidden_size, bias=False, **f)
        # Qwen3 per-head q/k RMSNorm over head_dim (fp32 weights, as in JAX)
        self.q_norm = MojoRMSNorm(D, eps=c.rms_norm_eps, device=device)
        self.k_norm = MojoRMSNorm(D, eps=c.rms_norm_eps, device=device)
        self.apply_rope = MojoApplyRoPE()
        self.store_kv = MojoStorePagedKVCache(kv_layout=c.kv_layout)
        self.attn_prefill = MojoPagedPrefillGQA(gqa_layout="AABB", kv_layout=c.kv_layout)
        self.attn_decode = MojoPagedDecodeGQA(gqa_layout="AABB", kv_layout=c.kv_layout)

    def forward(
        self,
        hidden: torch.Tensor,  # (T, hidden)
        cos: torch.Tensor,
        sin: torch.Tensor,
        meta: AttentionMetadata,
        caches: KVCaches,
        layer_idx: int,
    ) -> torch.Tensor:
        T = hidden.shape[0]
        q = self.q_proj(hidden).reshape(T, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(T, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).reshape(T, self.num_kv_heads, self.head_dim)
        q = self.q_norm(q)
        k = self.k_norm(k)
        q, k = self.apply_rope(q, k, cos, sin, head_first=False)

        key_cache, value_cache = caches.key(layer_idx), caches.value(layer_idx)
        self.store_kv(k, v, key_cache, value_cache, token_indices=meta.token_indices)
        if meta.is_prefill:
            attn = self.attn_prefill(
                q, key_cache, value_cache, meta.cu_q_lens, meta.block_tables, None, meta.cu_total_seq_lens,
                max_q_len=meta.max_q_len, max_total_seq_len=meta.max_total_seq_len,
            )
        else:
            attn = self.attn_decode(
                q, key_cache, value_cache, meta.total_seq_lens, meta.block_tables,
                max_total_seq_len=meta.max_total_seq_len,
            )
        return self.o_proj(attn.reshape(T, self.num_heads * self.head_dim))


class Qwen3MLP(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        f = dict(device=device, dtype=c.dtype)
        self.gate_proj = MojoGemm(c.hidden_size, c.intermediate_size, bias=False, **f)
        self.up_proj = MojoGemm(c.hidden_size, c.intermediate_size, bias=False, **f)
        self.down_proj = MojoGemm(c.intermediate_size, c.hidden_size, bias=False, **f)
        self.act = MojoSilu()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        self.input_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = Qwen3Attention(c, device)
        self.post_attention_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.mlp = Qwen3MLP(c, device)

    def forward(self, hidden, cos, sin, meta, caches, layer_idx):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin, meta, caches, layer_idx)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class Qwen3Model(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        self.embed_tokens = MojoEmbedding(c.vocab_size, c.hidden_size, device=device, dtype=c.dtype)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(c, device) for _ in range(c.num_hidden_layers))
        self.norm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(c.rope_theta, c.head_dim, device=device)

    def forward(self, input_ids, positions, meta, caches):
        hidden = self.embed_tokens(input_ids)
        cos, sin = self.rotary_emb(hidden, position_ids=positions)
        cos = cos.to(hidden.dtype)
        sin = sin.to(hidden.dtype)
        for layer_idx, layer in enumerate(self.layers):
            hidden = layer(hidden, cos, sin, meta, caches, layer_idx)
        return self.norm(hidden)


class Qwen3ForCausalLM(nn.Module):
    """Paged-generation Qwen3.

    ``forward(input_ids, positions, metadata, caches, lm_head_indices)``
    returns fp32 logits and writes the step's K/V into ``caches``; with
    ``lm_head_indices`` only those rows (the last token of each prefill
    sequence) hit the LM head. ``generator`` draws the weights
    (``utils.weights.init_random_``); otherwise torch's default RNG does.
    """

    def __init__(self, config: Qwen3Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self._config = config
        self.model = Qwen3Model(config, device)
        self.lm_head = (
            None
            if config.tie_word_embeddings
            else MojoGemm(config.hidden_size, config.vocab_size, bias=False, device=device, dtype=config.dtype)
        )
        if generator is not None:
            from mojo_opset_tpu_torch.utils.weights import init_random_

            init_random_(self, generator)

    @property
    def config(self) -> MojoConfig:
        return self._config.to_mojo()

    def forward(self, input_ids, positions, meta, caches, lm_head_indices=None) -> torch.Tensor:
        hidden = self.model(input_ids, positions, meta, caches)
        if lm_head_indices is not None:
            hidden = hidden[lm_head_indices]
        if self.lm_head is None:
            logits = torch.matmul(hidden, self.model.embed_tokens.weight.t())
        else:
            logits = self.lm_head(hidden)
        return logits.float()
