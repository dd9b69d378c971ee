"""DeepSeek-V3 (MLA + MoE) for paged serving.

Counterpart of the JAX package's ``modeling/deepseekv3/modeling_deepseek_v3.py``
(``DeepseekV3Config`` :47, ``MLARuntimeState`` :109, ``DeepseekV3MLP`` :132,
``DeepseekV3MoE`` :161, ``DeepseekV3Attention`` :185,
``DeepseekV3DecoderLayer`` :314, ``DeepseekV3Model`` :339,
``DeepseekV3ForCausalLM`` :362):
  * Multi-head Latent Attention: q LoRA (``q_a_proj``, ``q_a_layernorm``,
    ``q_b_proj``; one ``q_proj`` with ``q_lora_rank=None``),
    ``kv_a_proj_with_mqa`` into the latent ``c_kv`` (r) and the rope key
    (dr), both stored by ``MojoStorePagedMLAKVCache`` in the session's
    latent caches (``MLARuntimeState``), attention by
    ``MojoPagedPrefillMLA`` / ``MojoPagedDecodeMLA``, which own the fp32
    decompression weight ``kv_b_proj``;
  * MoE layers from ``first_k_dense_replace`` on: ``MojoMoE`` routed
    experts plus a shared-expert MLP; the first layers a dense MLP.

Like the JAX model it has plain ``rope_theta`` RoPE with scale
``qk_head_dim ** -0.5`` (no YaRN), softmax -> top-k -> renormalize routing
(no sigmoid, group-limited ``noaux_tc`` routing, no
``routed_scaling_factor``) and no multi-token prediction. Attribute names
follow the JAX model, so ``state_dict()`` keys equal ``state_dict_of`` of
the JAX model (with its ``model.`` level). The JAX model keeps two fp32
``kv_b_proj`` leaves, drawn alike (``attn_prefill`` and ``attn_decode``);
here the two ops share one tensor, both keys name it, and
``load_numpy_state`` raises if the two arrays differ.

``quant="w8a8"`` (JAX :199-227, :253-260, :306-308, :362-385): the q LoRA
is int8 GEMM -> ``MojoRMSNormQuant`` -> int8 GEMM, fed by the input norm's
per-token int8 (``MojoRMSNormQuant``); ``kv_a_proj_with_mqa`` and
``o_proj`` are int8 GEMMs, with a ``MojoDynamicQuant`` before ``o_proj``;
the dense and shared MLPs quantize their fp input (``in_quant``) and their
activation (``act_quant``) around int8 gate/up and down GEMMs; the routed
experts are ``MojoQuantMoE`` (int8); the lm_head is int8 behind a
``MojoDynamicQuant``. The MLA ops and their fp32 ``kv_b_proj`` and every
norm but the two quantizing ones stay as they are. The weights come from
``quantize_deepseek_v3`` or ``load_numpy_state``.
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
    MojoMoE,
    MojoQuantGemm,
    MojoQuantMoE,
    MojoRMSNorm,
    MojoRMSNormQuant,
    MojoRotaryEmbedding,
    MojoSilu,
)
from mojo_opset_tpu_torch.experimental.operators import (
    MojoPagedDecodeMLA,
    MojoPagedPrefillMLA,
    MojoStorePagedMLAKVCache,
)
from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig
from mojo_opset_tpu_torch.runtime.session import AttentionMetadata, KVCaches, PagedAttentionRuntimeState
from mojo_opset_tpu_torch.utils.platform import resolve_device


QUANT_MODES = (None, "w8a8")


@dataclass
class DeepseekV3Config:
    # DeepSeek-V3's widths (huggingface.co/deepseek-ai/DeepSeek-V3, config.json), as in the JAX config
    hidden_size: int = 7168
    intermediate_size: int = 18432
    moe_intermediate_size: int = 2048
    num_attention_heads: int = 128
    num_hidden_layers: int = 61
    vocab_size: int = 129280
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    q_lora_rank: Optional[int] = 1536
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    first_k_dense_replace: int = 3

    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    # "w8a8": int8 weights and per-token int8 activations on every projection and the routed experts
    quant: Optional[str] = None

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {self.quant!r}")

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def to_mojo(self) -> MojoConfig:
        return MojoConfig(
            model_config=MojoModelConfig(
                model_name="deepseek_v3",
                hidden_size=self.hidden_size,
                head_dim=self.qk_head_dim,
                num_heads=self.num_attention_heads,
                num_kv_heads=1,
                num_layers=self.num_hidden_layers,
                vocab_size=self.vocab_size,
                max_position_embeddings=self.max_position_embeddings,
                dtype=self.dtype,
                rope_theta=self.rope_theta,
                rms_norm_eps=self.rms_norm_eps,
                intermediate_size=self.intermediate_size,
                moe_expert_num=self.n_routed_experts,
                moe_topk=self.num_experts_per_tok,
                moe_ffn_internal_dim=self.moe_intermediate_size,
                tie_word_embeddings=self.tie_word_embeddings,
                extra={"kv_lora_rank": self.kv_lora_rank, "qk_rope_head_dim": self.qk_rope_head_dim},
            )
        )


class MLARuntimeState(PagedAttentionRuntimeState):
    """Paged session whose caches hold MLA latents: keys are the compressed
    ``c_kv`` ``(N, 1, bs, kv_lora_rank)``, values the rope keys ``(N, 1,
    bs, qk_rope_head_dim)``, exactly ``dr`` wide (the JAX session pads them
    to 128 lanes for its TPU kernel). Only these caches are allocated."""

    def _create_caches(self, total_blocks: int) -> KVCaches:
        mc = self.config.model_config
        self.kv_layout = "HND"  # (N, 1, bs, D): one shared latent "head"

        def zeros(width):
            return [torch.zeros((total_blocks, 1, self.block_size, width), dtype=self.dtype, device=self.device)
                    for _ in range(mc.num_layers)]

        return KVCaches(zeros(mc.extra["kv_lora_rank"]), zeros(mc.extra["qk_rope_head_dim"]))


def _linear(c: DeepseekV3Config, in_features: int, out_features: int, device):
    """A projection: an int8 GEMM under w8a8, else a float one."""
    if c.quant is not None:
        return MojoQuantGemm(in_features, out_features, output_dtype=c.dtype, trans_weight=True, device=device)
    return MojoGemm(in_features, out_features, bias=False, device=device, dtype=c.dtype)


class DeepseekV3MLP(nn.Module):
    def __init__(self, c: DeepseekV3Config, intermediate_size: Optional[int] = None, device=None):
        super().__init__()
        inter = intermediate_size or c.intermediate_size
        self.quant = c.quant is not None
        self.gate_proj = _linear(c, c.hidden_size, inter, device)
        self.up_proj = _linear(c, c.hidden_size, inter, device)
        self.down_proj = _linear(c, inter, c.hidden_size, device)
        if self.quant:
            # the input is a shared fp norm output (the MoE layers feed the same hidden to the fp gate)
            self.in_quant = MojoDynamicQuant()
            self.act_quant = MojoDynamicQuant()
        self.act = MojoSilu()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            x = self.in_quant(x)
            h = self.act(self.gate_proj(*x)) * self.up_proj(*x)
            return self.down_proj(*self.act_quant(h))
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))


class DeepseekV3MoE(nn.Module):
    """Routed ``MojoMoE`` plus the shared-expert MLP."""

    def __init__(self, c: DeepseekV3Config, device=None):
        super().__init__()
        moe = dict(num_experts=c.n_routed_experts, top_k=c.num_experts_per_tok, hidden_size=c.hidden_size,
                   intermediate_size=c.moe_intermediate_size, device=device)
        self.routed_experts = MojoMoE(**moe, dtype=c.dtype) if c.quant is None else MojoQuantMoE(**moe)
        self.shared_experts = DeepseekV3MLP(c, c.moe_intermediate_size * c.n_shared_experts, device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.routed_experts(hidden) + self.shared_experts(hidden)


class DeepseekV3Attention(nn.Module):
    """Multi-head Latent Attention over the paged latent cache."""

    def __init__(self, c: DeepseekV3Config, device=None):
        super().__init__()
        self.num_heads = c.num_attention_heads
        self.q_lora_rank = c.q_lora_rank
        self.kv_lora_rank = c.kv_lora_rank
        self.qk_nope_head_dim = c.qk_nope_head_dim
        self.qk_head_dim = c.qk_head_dim
        self.v_head_dim = c.v_head_dim
        self.quant = c.quant is not None
        if c.q_lora_rank is None:
            self.q_proj = _linear(c, c.hidden_size, self.num_heads * self.qk_head_dim, device)
        else:
            self.q_a_proj = _linear(c, c.hidden_size, c.q_lora_rank, device)
            # under w8a8 the fused norm + quant sits between the two q LoRA stages
            norm = MojoRMSNormQuant if self.quant else MojoRMSNorm
            self.q_a_layernorm = norm(c.q_lora_rank, eps=c.rms_norm_eps, device=device)
            self.q_b_proj = _linear(c, c.q_lora_rank, self.num_heads * self.qk_head_dim, device)
        self.kv_a_proj_with_mqa = _linear(c, c.hidden_size, c.kv_lora_rank + c.qk_rope_head_dim, device)
        self.kv_a_layernorm = MojoRMSNorm(c.kv_lora_rank, eps=c.rms_norm_eps, device=device)
        self.o_proj = _linear(c, self.num_heads * c.v_head_dim, c.hidden_size, device)
        if self.quant:
            self.attn_quant = MojoDynamicQuant()

        self.rope = MojoApplyRoPE()
        self.store_kv = MojoStorePagedMLAKVCache()
        mla = (self.num_heads, c.qk_nope_head_dim, c.qk_rope_head_dim, c.v_head_dim, c.kv_lora_rank)
        self.attn_prefill = MojoPagedPrefillMLA(*mla, device=device)
        self.attn_decode = MojoPagedDecodeMLA(*mla, device=device)
        self.attn_decode.kv_b_proj = self.attn_prefill.kv_b_proj  # one decompression weight (module docstring)
        self.scaling = self.qk_head_dim ** (-0.5)

    def forward(self, hidden, cos, sin, meta: AttentionMetadata, caches: KVCaches, layer_idx: int) -> torch.Tensor:
        """``hidden``: (T, hidden), or (int8 (T, hidden), scale (T, 1)) under w8a8."""
        x = hidden if self.quant else (hidden,)  # the projections' arguments
        T = x[0].shape[0]
        if self.q_lora_rank is None:
            q = self.q_proj(*x)
        else:
            q_a = self.q_a_layernorm(self.q_a_proj(*x))
            q = self.q_b_proj(*q_a) if self.quant else self.q_b_proj(q_a)
        q = q.reshape(T, self.num_heads, self.qk_head_dim)
        ckv_full = self.kv_a_proj_with_mqa(*x)
        c_kv = self.kv_a_layernorm(ckv_full[:, : self.kv_lora_rank].contiguous())
        q_rot, k_rot = self.rope(q[..., self.qk_nope_head_dim:].contiguous(),
                                 ckv_full[:, None, self.kv_lora_rank:].contiguous(), cos, sin, head_first=False)
        query = torch.cat([q[..., : self.qk_nope_head_dim], q_rot], dim=-1)

        ckv_cache, kpe_cache = caches.key(layer_idx), caches.value(layer_idx)
        self.store_kv(c_kv, k_rot[:, 0], ckv_cache, kpe_cache, token_indices=meta.token_indices)
        if meta.is_prefill:
            attn = self.attn_prefill(query, ckv_cache, kpe_cache, meta.cu_q_lens, meta.block_tables, self.scaling,
                                     meta.cu_total_seq_lens)
        else:
            attn = self.attn_decode(query, ckv_cache, kpe_cache, meta.total_seq_lens, meta.block_tables,
                                    self.scaling)
        attn = attn.reshape(T, self.num_heads * self.v_head_dim)
        return self.o_proj(*self.attn_quant(attn)) if self.quant else self.o_proj(attn)


class DeepseekV3DecoderLayer(nn.Module):
    def __init__(self, c: DeepseekV3Config, layer_idx: int, device=None):
        super().__init__()
        # under w8a8 the fused norm + quant feeds int8 into the attention; the post-attention norm stays fp (it
        # feeds the fp MoE gate; the MLPs and the routed experts quantize their own inputs)
        norm = MojoRMSNorm if c.quant is None else MojoRMSNormQuant
        self.input_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = DeepseekV3Attention(c, device)
        self.post_attention_layernorm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.mlp = DeepseekV3MoE(c, device) if layer_idx >= c.first_k_dense_replace else DeepseekV3MLP(c, None, device)

    def forward(self, hidden, cos, sin, meta, caches, layer_idx):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin, meta, caches, layer_idx)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class DeepseekV3Model(nn.Module):
    def __init__(self, c: DeepseekV3Config, device=None):
        super().__init__()
        self.embed_tokens = MojoEmbedding(c.vocab_size, c.hidden_size, device=device, dtype=c.dtype)
        self.layers = nn.ModuleList(DeepseekV3DecoderLayer(c, i, device) for i in range(c.num_hidden_layers))
        self.norm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(c.rope_theta, c.qk_rope_head_dim, device=device)

    def forward(self, input_ids, positions, meta, caches):
        hidden = self.embed_tokens(input_ids)
        cos, sin = self.rotary_emb(hidden, position_ids=positions)
        cos, sin = cos.to(hidden.dtype), sin.to(hidden.dtype)
        for layer_idx, layer in enumerate(self.layers):
            hidden = layer(hidden, cos, sin, meta, caches, layer_idx)
        return self.norm(hidden)


class DeepseekV3ForCausalLM(nn.Module):
    """Paged-generation DeepSeek-V3: ``forward(input_ids, positions,
    metadata, caches, lm_head_indices)`` returns fp32 logits and writes the
    step's latents into ``caches``, whose session is an ``MLARuntimeState``
    (``PagedAttentionGenerationModel(model, session_cls=MLARuntimeState)``).
    Built on the card unless ``device`` names another; ``generator`` draws
    the weights (``utils.weights.init_random_``)."""

    def __init__(self, config: DeepseekV3Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self._config = config
        self.model = DeepseekV3Model(config, device)
        quant = config.quant is not None and not config.tie_word_embeddings
        self.lm_head_quant = MojoDynamicQuant() if quant else None
        self.lm_head = None if config.tie_word_embeddings else _linear(config, config.hidden_size,
                                                                        config.vocab_size, device)
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
        elif self.lm_head_quant is not None:
            logits = self.lm_head(*self.lm_head_quant(hidden))
        else:
            logits = self.lm_head(hidden)
        return logits.float()
