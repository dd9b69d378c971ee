"""Seed-OSS for paged serving.

Counterpart of the JAX package's ``modeling/seed_oss/modeling_seed_oss.py``:
the Qwen3 paged-GQA stack (``modeling/qwen3/modeling_qwen3.py``) with
biases on the q/k/v projections (``attention_bias``; o and the MLP take
them on their own flags), no per-head q/k norms, and the attention scale
``head_dim ** -0.5`` passed to the paged ops. It has no ``model.`` level
(``embed_tokens``, ``layers``, ``norm`` and ``lm_head`` at the top), so
``state_dict()`` keys equal the JAX package's ``utils.hf.state_dict_of``
keys. Residual dropout, a no-op at inference in JAX, is not carried.

``quant="w8a8"``: int8 weights on every projection and the lm_head, fed
per-token int8 activations by ``MojoRMSNormQuant`` and ``MojoDynamicQuant``;
the int8 GEMM takes no bias, so the biases stay in floating point as the
attention's ``{q,k,v,o}_bias`` parameters, added to the GEMMs' outputs (JAX
:96-100, :118-119, :149-150). The quantized weights come from
``quantize_seed_oss`` or ``load_numpy_state``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.operators import (
    MojoApplyRoPE,
    MojoDynamicQuant,
    MojoEmbedding,
    MojoGemm,
    MojoPagedDecodeGQA,
    MojoPagedPrefillGQA,
    MojoQuantGemm,
    MojoRMSNorm,
    MojoRMSNormQuant,
    MojoRotaryEmbedding,
    MojoSilu,
    MojoStorePagedKVCache,
)
from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig, MojoRunTimeConfig
from mojo_opset_tpu_torch.runtime.session import AttentionMetadata, KVCaches
from mojo_opset_tpu_torch.utils.platform import resolve_device

QUANT_MODES = (None, "w8a8")


@dataclass
class SeedOssConfig:
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    num_hidden_layers: int = 32
    head_dim: int = 128
    vocab_size: int = 100352
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000000.0
    attention_bias: bool = True
    attention_out_bias: bool = False
    mlp_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    kv_layout: str = "NHD"
    # "w8a8": int8 weights and per-token int8 activations; the biases stay in floating point
    quant: Optional[str] = None

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {self.quant!r}")
        if self.quant is not None and self.mlp_bias:
            raise NotImplementedError("the w8a8 MLP takes no bias (as in the JAX model)")

    def to_mojo(self) -> MojoConfig:
        return MojoConfig(
            model_config=MojoModelConfig(
                model_name="seed_oss",
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
                extra=dict(has_attn_bias=self.attention_bias),
            ),
            runtime_config=MojoRunTimeConfig(use_device_graph=True),
        )


def _quant_gemm(c: SeedOssConfig, in_features: int, out_features: int, device) -> MojoQuantGemm:
    return MojoQuantGemm(in_features, out_features, output_dtype=c.dtype, trans_weight=True, device=device)


def _bias(c: SeedOssConfig, n: int, present: bool, device) -> Optional[nn.Parameter]:
    """A floating-point bias beside an int8 GEMM, or None."""
    if not present:
        return None
    return nn.Parameter(torch.zeros(n, device=device, dtype=c.dtype), requires_grad=False)


class SeedOssAttention(nn.Module):
    def __init__(self, c: SeedOssConfig, device=None):
        super().__init__()
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.num_heads = H
        self.num_kv_heads = Hkv
        self.head_dim = D
        self.quant = c.quant is not None
        if self.quant:
            self.q_proj = _quant_gemm(c, c.hidden_size, H * D, device)
            self.k_proj = _quant_gemm(c, c.hidden_size, Hkv * D, device)
            self.v_proj = _quant_gemm(c, c.hidden_size, Hkv * D, device)
            self.o_proj = _quant_gemm(c, H * D, c.hidden_size, device)
            self.q_bias = _bias(c, H * D, c.attention_bias, device)
            self.k_bias = _bias(c, Hkv * D, c.attention_bias, device)
            self.v_bias = _bias(c, Hkv * D, c.attention_bias, device)
            self.o_bias = _bias(c, c.hidden_size, c.attention_out_bias, device)
            self.attn_quant = MojoDynamicQuant()
        else:
            f = dict(device=device, dtype=c.dtype)
            self.q_proj = MojoGemm(c.hidden_size, H * D, bias=c.attention_bias, **f)
            self.k_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
            self.v_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
            self.o_proj = MojoGemm(H * D, c.hidden_size, bias=c.attention_out_bias, **f)
        self.rope = MojoApplyRoPE()
        self.store_kv = MojoStorePagedKVCache(kv_layout=c.kv_layout)
        self.attn_prefill = MojoPagedPrefillGQA(gqa_layout="AABB", kv_layout=c.kv_layout)
        self.attn_decode = MojoPagedDecodeGQA(gqa_layout="AABB", kv_layout=c.kv_layout)
        self.scaling = D**-0.5

    def forward(
        self,
        hidden,  # (T, hidden), or (int8 (T, hidden), scale (T, 1)) when quantized
        cos: torch.Tensor,
        sin: torch.Tensor,
        meta: AttentionMetadata,
        caches: KVCaches,
        layer_idx: int,
    ) -> torch.Tensor:
        x = hidden if self.quant else (hidden,)  # the projections' arguments
        T = x[0].shape[0]
        q, k, v = self.q_proj(*x), self.k_proj(*x), self.v_proj(*x)
        if self.quant and self.q_bias is not None:
            q, k, v = q + self.q_bias, k + self.k_bias, v + self.v_bias
        q = q.reshape(T, self.num_heads, self.head_dim)
        k = k.reshape(T, self.num_kv_heads, self.head_dim)
        v = v.reshape(T, self.num_kv_heads, self.head_dim)
        q, k = self.rope(q, k, cos, sin, head_first=False)

        key_cache, value_cache = caches.key(layer_idx), caches.value(layer_idx)
        self.store_kv(k, v, key_cache, value_cache, token_indices=meta.token_indices)
        if meta.is_prefill:
            attn = self.attn_prefill(
                q, key_cache, value_cache, meta.cu_q_lens, meta.block_tables, self.scaling, meta.cu_total_seq_lens,
                max_q_len=meta.max_q_len, max_total_seq_len=meta.max_total_seq_len,
            )
        else:
            attn = self.attn_decode(
                q, key_cache, value_cache, meta.total_seq_lens, meta.block_tables, self.scaling,
                max_total_seq_len=meta.max_total_seq_len,
            )
        attn = attn.reshape(T, self.num_heads * self.head_dim)
        if not self.quant:
            return self.o_proj(attn)
        out = self.o_proj(*self.attn_quant(attn))
        return out if self.o_bias is None else out + self.o_bias


class SeedOssMLP(nn.Module):
    def __init__(self, c: SeedOssConfig, device=None):
        super().__init__()
        self.quant = c.quant is not None
        if self.quant:
            self.gate_proj = _quant_gemm(c, c.hidden_size, c.intermediate_size, device)
            self.up_proj = _quant_gemm(c, c.hidden_size, c.intermediate_size, device)
            self.down_proj = _quant_gemm(c, c.intermediate_size, c.hidden_size, device)
            self.act_quant = MojoDynamicQuant()
        else:
            f = dict(bias=c.mlp_bias, device=device, dtype=c.dtype)
            self.gate_proj = MojoGemm(c.hidden_size, c.intermediate_size, **f)
            self.up_proj = MojoGemm(c.hidden_size, c.intermediate_size, **f)
            self.down_proj = MojoGemm(c.intermediate_size, c.hidden_size, **f)
        self.act = MojoSilu()

    def forward(self, x) -> torch.Tensor:
        """x: (T, hidden), or (int8 (T, hidden), scale (T, 1)) when quantized."""
        if self.quant:
            h = self.act(self.gate_proj(*x)) * self.up_proj(*x)
            return self.down_proj(*self.act_quant(h))
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class SeedOssDecoderLayer(nn.Module):
    def __init__(self, c: SeedOssConfig, device=None):
        super().__init__()
        # under w8a8 the fused norm + quant feeds int8 straight into the projections
        norm = MojoRMSNorm if c.quant is None else MojoRMSNormQuant
        self.input_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = SeedOssAttention(c, device)
        self.post_attention_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.mlp = SeedOssMLP(c, device)

    def forward(self, hidden, cos, sin, meta, caches, layer_idx):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin, meta, caches, layer_idx)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class SeedOssForCausalLM(nn.Module):
    """Paged-generation Seed-OSS.

    ``forward(input_ids, positions, metadata, caches, lm_head_indices)``
    returns fp32 logits and writes the step's K/V into ``caches``, as
    ``Qwen3ForCausalLM`` does. ``generator`` draws the weights
    (``utils.weights.init_random_``: biases too); otherwise torch's default
    RNG does. The model is built on the card unless ``device`` names
    another (``utils.platform.resolve_device``).
    """

    def __init__(self, config: SeedOssConfig, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self._config = config
        self.embed_tokens = MojoEmbedding(config.vocab_size, config.hidden_size, device=device, dtype=config.dtype)
        self.layers = nn.ModuleList(SeedOssDecoderLayer(config, device) for _ in range(config.num_hidden_layers))
        self.norm = MojoRMSNorm(config.hidden_size, eps=config.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(config.rope_theta, config.head_dim, device=device)
        quant = config.quant is not None and not config.tie_word_embeddings
        self.lm_head_quant = MojoDynamicQuant() if quant else None
        if config.tie_word_embeddings:
            self.lm_head = None
        elif quant:
            self.lm_head = _quant_gemm(config, config.hidden_size, config.vocab_size, device)
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
    def seed_oss_config(self) -> SeedOssConfig:
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
