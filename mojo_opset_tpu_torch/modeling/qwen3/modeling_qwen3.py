"""Qwen3 dense model for paged serving.

Counterpart of the JAX package's ``modeling/qwen3/modeling_qwen3.py``:
packed varlen token layout (T, hidden) for prefill and (B, hidden) for
decode; the model writes the session's KV caches in place and returns fp32
logits. It names only core ops, so the tier (``MOJO_BACKEND``) is
invisible to it. Attribute names follow the JAX model, so ``state_dict()``
keys equal the JAX package's ``utils.hf.state_dict_of`` keys.

Serving modes, as in the JAX model: ``quant="w8a8"`` gives int8 weights
on every projection and the lm_head, fed per-token int8 activations by
``MojoRMSNormQuant`` (the two layer norms) and ``MojoDynamicQuant`` (before
o_proj, down_proj and the lm_head); ``quant="w4a8"`` packs int4 into every
projection whose width is a multiple of 128 (the others stay int8) and
keeps the lm_head int8; ``quant_kv=True`` gives the int8 (C8) KV cache,
HND, with per-layer channel scales calibrated at the first prefill. The
quantized weights come from ``quantize_qwen3`` or ``load_numpy_state``.

Training (JAX model :235-249, :304-310, :332-347, :405-418):
``train_forward(ids)`` runs the padded (B, S) batch through the layers'
``dense_forward`` and returns the final hidden states, to pair with
``fused_linear_cross_entropy(hidden, lm_head_weight, targets)``. It runs
the training Functions: ``MojoRMSNormFunction`` with each norm's own
weight, ``MojoApplyRoPEFunction``, ``MojoSWAFunction`` and the MLP's
``MojoSiluFunction`` (kernels A/K, M, J and L on the cuda tier). Gradients
are off by default (the parameters serve); a trainer turns them on with
``model.requires_grad_(True)``. Quantized models do not train.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mojo_opset_tpu_torch.core.functions import (
    MojoApplyRoPEFunction,
    MojoRMSNormFunction,
    MojoSiluFunction,
    MojoSWAFunction,
)
from mojo_opset_tpu_torch.core.functions.loss import VocabShard
from mojo_opset_tpu_torch.core.operators import (
    MojoApplyRoPE,
    MojoDynamicQuant,
    MojoEmbedding,
    MojoGemm,
    MojoPagedDecodeGQA,
    MojoPagedPrefillGQA,
    MojoParallelEmbedding,
    MojoQuantGemm,
    MojoRMSNorm,
    MojoRMSNormQuant,
    MojoRotaryEmbedding,
    MojoSilu,
    MojoStorePagedKVCache,
)
from mojo_opset_tpu_torch.core.operators.gemm import INT4_BLOCK
from mojo_opset_tpu_torch.experimental.operators import (
    MojoPagedDecodeGQAWithKVDequant,
    MojoPagedPrefillGQAWithKVDequant,
    MojoStorePagedKVCacheC8,
)
from mojo_opset_tpu_torch.runtime import comm_context
from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig, MojoRunTimeConfig, sharded_config
from mojo_opset_tpu_torch.runtime.session import AttentionMetadata, KVCaches
from mojo_opset_tpu_torch.utils.platform import resolve_device


QUANT_MODES = (None, "w8a8", "w4a8")


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
    # "w8a8": int8 weights and per-token int8 activations on every projection;
    # "w4a8": the same with packed-int4 weights where the width allows
    quant: Optional[str] = None
    # int8 (C8) KV cache with channel scales self-calibrated at prefill; forces HND
    quant_kv: bool = False

    def __post_init__(self):
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {self.quant!r}")

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
                kv_layout="HND" if self.quant_kv else self.kv_layout,
                kv_cache_quant=self.quant_kv,
            ),
            runtime_config=MojoRunTimeConfig(use_device_graph=True),
        )


class Qwen3Attention(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        H, Hkv, D = c.num_attention_heads, c.num_key_value_heads, c.head_dim
        self.num_heads = H
        self.num_kv_heads = Hkv
        self.head_dim = D
        self.quant = c.quant is not None
        if self.quant:
            if c.attention_bias:
                raise NotImplementedError("the quantized projections take no bias")
            self.q_proj = _quant_gemm(c, c.hidden_size, H * D, device)
            self.k_proj = _quant_gemm(c, c.hidden_size, Hkv * D, device)
            self.v_proj = _quant_gemm(c, c.hidden_size, Hkv * D, device)
            self.o_proj = _quant_gemm(c, H * D, c.hidden_size, device)
            self.attn_quant = MojoDynamicQuant()
        else:
            f = dict(device=device, dtype=c.dtype)
            self.q_proj = MojoGemm(c.hidden_size, H * D, bias=c.attention_bias, **f)
            self.k_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
            self.v_proj = MojoGemm(c.hidden_size, Hkv * D, bias=c.attention_bias, **f)
            self.o_proj = MojoGemm(H * D, c.hidden_size, bias=False, **f)
        # Qwen3 per-head q/k RMSNorm over head_dim (fp32 weights, as in JAX)
        self.q_norm = MojoRMSNorm(D, eps=c.rms_norm_eps, device=device)
        self.k_norm = MojoRMSNorm(D, eps=c.rms_norm_eps, device=device)
        self.apply_rope = MojoApplyRoPE()
        self.quant_kv = c.quant_kv
        if self.quant_kv:
            self.store_kv = MojoStorePagedKVCacheC8()
            self.attn_prefill = MojoPagedPrefillGQAWithKVDequant(
                gqa_layout="AABB", query_dtype=c.dtype, compute_dtype=c.dtype)
            self.attn_decode = MojoPagedDecodeGQAWithKVDequant(
                gqa_layout="AABB", query_dtype=c.dtype, compute_dtype=c.dtype)
        else:
            self.store_kv = MojoStorePagedKVCache(kv_layout=c.kv_layout)
            self.attn_prefill = MojoPagedPrefillGQA(gqa_layout="AABB", kv_layout=c.kv_layout)
            self.attn_decode = MojoPagedDecodeGQA(gqa_layout="AABB", kv_layout=c.kv_layout)
        # the training path's Functions (dense_forward)
        self.norm_train = MojoRMSNormFunction(eps=c.rms_norm_eps)
        self.rope_train = MojoApplyRoPEFunction()
        self.attn_train = MojoSWAFunction(is_causal=True, gqa_layout="AABB")

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
        q = self.q_proj(*x).reshape(T, self.num_heads, self.head_dim)
        k = self.k_proj(*x).reshape(T, self.num_kv_heads, self.head_dim)
        v = self.v_proj(*x).reshape(T, self.num_kv_heads, self.head_dim)
        q = self.q_norm(q)
        k = self.k_norm(k)
        q, k = self.apply_rope(q, k, cos, sin, head_first=False)

        key_cache, value_cache = caches.key(layer_idx), caches.value(layer_idx)
        if self.quant_kv:
            attn = self._int8_kv_attention(q, k, v, meta, caches, layer_idx)
        else:
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
        attn = attn.reshape(T, self.num_heads * self.head_dim)
        if self.quant:
            return self.o_proj(*self.attn_quant(attn))
        return self.o_proj(attn)

    def dense_forward(self, hidden: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """Causal self-attention for training over a padded batch, (B, S, hidden) in and out; sharded, the rank's
        heads, the input's gradient summed over the group (``block_input``) and the output's summed forward."""
        hidden = comm_context.block_input(self, hidden)
        B, S, _ = hidden.shape
        q = self.q_proj(hidden).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(B, S, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).reshape(B, S, self.num_kv_heads, self.head_dim)
        q = self.norm_train(q, self.q_norm.weight)
        k = self.norm_train(k, self.k_norm.weight)
        # token-first, as JAX :243; kernel M takes the (B, S, H, D) tensors as a transposed (B, H, S, D) view and
        # returns them token-first, so the reshapes below to J's packed rows copy nothing
        q, k = self.rope_train(q, k, cos, sin, head_first=False)
        # JAX (:244-248) runs MojoSdpa(enable_gqa=True) under a (S, S) tril mask on (B, H, S, D). The same
        # function is causal attention within each of B sequences of S tokens: the rows packed (B * S, H, D)
        # with cu = [0, S, 2S, ...] as both cu vectors, on kernel J's forward and backward. Detecting a causal
        # mask from its values would cost a host sync.
        cu = torch.arange(B + 1, dtype=torch.int32, device=hidden.device) * S
        o = self.attn_train(q.reshape(B * S, self.num_heads, self.head_dim),
                            k.reshape(B * S, self.num_kv_heads, self.head_dim),
                            v.reshape(B * S, self.num_kv_heads, self.head_dim), cu, cu)
        return self.o_proj(o.reshape(B, S, self.num_heads * self.head_dim))

    def _int8_kv_attention(self, q, k, v, meta: AttentionMetadata, caches: KVCaches, layer_idx: int):
        key_cache, value_cache = caches.key(layer_idx), caches.value(layer_idx)
        ks, vs = caches.key_scale(layer_idx), caches.value_scale(layer_idx)
        if meta.is_prefill:
            # the first prefill sets the channel scales (amax / 127, +25%
            # headroom); later chunks leave them frozen, since the int8
            # already cached was quantized under them (JAX model :171-201).
            # Decided on the device: no host sync in a layer.
            calibrated = ks.amax() > 0
            ks.copy_(torch.where(calibrated, ks, (k.float().abs().amax(0) / 127.0 * 1.25).clamp(min=1e-6)))
            vs.copy_(torch.where(calibrated, vs, (v.float().abs().amax(0) / 127.0 * 1.25).clamp(min=1e-6)))
        self.store_kv(k, v, key_cache, value_cache, ks, vs, token_indices=meta.token_indices)
        if meta.is_prefill:
            return self.attn_prefill(
                q, None, key_cache, ks, value_cache, vs, meta.cu_q_lens, meta.block_tables, None,
                meta.cu_total_seq_lens, max_q_len=meta.max_q_len, max_total_seq_len=meta.max_total_seq_len,
            )
        return self.attn_decode(
            q, None, key_cache, ks, value_cache, vs, meta.total_seq_lens, meta.block_tables,
            max_total_seq_len=meta.max_total_seq_len,
        )


class Qwen3MLP(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        self.quant = c.quant is not None
        if self.quant:
            self.gate_proj = _quant_gemm(c, c.hidden_size, c.intermediate_size, device)
            self.up_proj = _quant_gemm(c, c.hidden_size, c.intermediate_size, device)
            self.down_proj = _quant_gemm(c, c.intermediate_size, c.hidden_size, device)
            self.act_quant = MojoDynamicQuant()
        else:
            f = dict(device=device, dtype=c.dtype)
            self.gate_proj = MojoGemm(c.hidden_size, c.intermediate_size, bias=False, **f)
            self.up_proj = MojoGemm(c.hidden_size, c.intermediate_size, bias=False, **f)
            self.down_proj = MojoGemm(c.intermediate_size, c.hidden_size, bias=False, **f)
        self.act = MojoSilu()
        self.act_train = MojoSiluFunction()

    def forward(self, x) -> torch.Tensor:
        """x: (T, hidden), or (int8 (T, hidden), scale (T, 1)) when quantized."""
        if self.quant:
            h = self.act(self.gate_proj(*x)) * self.up_proj(*x)
            return self.down_proj(*self.act_quant(h))
        return self.down_proj(self.act(self.gate_proj(x)) * self.up_proj(x))

    def dense_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The training forward: the SiLU under its Function (sharded: the rank's channels, as ``dense_forward`` of
        the attention)."""
        x = comm_context.block_input(self, x)
        return self.down_proj(self.act_train(self.gate_proj(x)) * self.up_proj(x))


def _quant_gemm(c: Qwen3Config, in_features: int, out_features: int, device, int4: bool = True) -> MojoQuantGemm:
    """A projection of the quantized modes: packed int4 under w4a8 where
    ``out_features`` fills whole 128-channel groups (JAX model :110-113),
    int8 otherwise."""
    weight_dtype = "int4" if int4 and c.quant == "w4a8" and out_features % INT4_BLOCK == 0 else torch.int8
    return MojoQuantGemm(in_features, out_features, output_dtype=c.dtype, trans_weight=True,
                         weight_dtype=weight_dtype, device=device)


class Qwen3DecoderLayer(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        # under w8a8 and w4a8 the fused norm + quant feeds int8 straight into the projections
        norm = MojoRMSNorm if c.quant is None else MojoRMSNormQuant
        self.input_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.self_attn = Qwen3Attention(c, device)
        self.post_attention_layernorm = norm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.mlp = Qwen3MLP(c, device)
        self.norm_train = MojoRMSNormFunction(eps=c.rms_norm_eps)

    def forward(self, hidden, cos, sin, meta, caches, layer_idx):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos, sin, meta, caches, layer_idx)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))

    def dense_forward(self, hidden, cos, sin):
        hidden = hidden + self.self_attn.dense_forward(self.norm_train(hidden, self.input_layernorm.weight), cos, sin)
        return hidden + self.mlp.dense_forward(self.norm_train(hidden, self.post_attention_layernorm.weight))


class Qwen3Model(nn.Module):
    def __init__(self, c: Qwen3Config, device=None):
        super().__init__()
        self.embed_tokens = MojoEmbedding(c.vocab_size, c.hidden_size, device=device, dtype=c.dtype)
        self.layers = nn.ModuleList(Qwen3DecoderLayer(c, device) for _ in range(c.num_hidden_layers))
        self.norm = MojoRMSNorm(c.hidden_size, eps=c.rms_norm_eps, device=device)
        self.rotary_emb = MojoRotaryEmbedding(c.rope_theta, c.head_dim, device=device)
        self.norm_train = MojoRMSNormFunction(eps=c.rms_norm_eps)

    def forward(self, input_ids, positions, meta, caches):
        hidden = self.embed_tokens(input_ids)
        cos, sin = self.rotary_emb(hidden, position_ids=positions)
        cos = cos.to(hidden.dtype)
        sin = sin.to(hidden.dtype)
        for layer_idx, layer in enumerate(self.layers):
            hidden = layer(hidden, cos, sin, meta, caches, layer_idx)
        return self.norm(hidden)

    def dense_forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Training forward: causal attention over padded (B, S) ids."""
        if any(layer.self_attn.quant for layer in self.layers):
            raise NotImplementedError(
                "serving-mode (quant) models are inference-only; train the fp model and quantize post-training"
            )
        B, S = input_ids.shape
        hidden = self.embed_tokens(input_ids)
        positions = torch.arange(S, dtype=torch.int32, device=input_ids.device).expand(B, S)
        cos, sin = self.rotary_emb(hidden, position_ids=positions)
        cos, sin = cos.to(hidden.dtype), sin.to(hidden.dtype)
        for layer in self.layers:
            hidden = layer.dense_forward(hidden, cos, sin)
        return self.norm_train(hidden, self.norm.weight)


def tied_logits(hidden: torch.Tensor, embedding) -> torch.Tensor:
    """The tied LM head: ``hidden @ embedding.T``; a vocab-parallel embedding's column shards gathered."""
    logits = torch.matmul(hidden, embedding.weight.t())
    return embedding.gather_logits(logits) if isinstance(embedding, MojoParallelEmbedding) else logits


class Qwen3ForCausalLM(nn.Module):
    """Paged-generation Qwen3.

    ``forward(input_ids, positions, metadata, caches, lm_head_indices)``
    returns fp32 logits and writes the step's K/V into ``caches``; with
    ``lm_head_indices`` only those rows (the last token of each prefill
    sequence) hit the LM head. Sharded by ``parallel`` (``shard_model``,
    ``mojo_parallelize_module``) it runs the rank's heads and channels, its
    collectives placed by the styles, and every rank returns the whole
    logits (a vocab-parallel head gathers them). ``generator`` draws the weights
    (``utils.weights.init_random_``); otherwise torch's default RNG does.
    The model is built on the card unless ``device`` names another
    (``utils.platform.resolve_device``).
    """

    def __init__(self, config: Qwen3Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self._config = config
        self.model = Qwen3Model(config, device)
        quant = config.quant is not None and not config.tie_word_embeddings
        self.lm_head_quant = MojoDynamicQuant() if quant else None
        if config.tie_word_embeddings:
            self.lm_head = None
        elif quant:
            # int8 under w4a8 too: int4 over the vocabulary costs logit fidelity (JAX model :371-378)
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
    def qwen3_config(self) -> Qwen3Config:
        return self._config

    def forward(self, input_ids, positions, meta, caches, lm_head_indices=None) -> torch.Tensor:
        hidden = self.model(input_ids, positions, meta, caches)
        if lm_head_indices is not None:
            hidden = hidden[lm_head_indices]
        if self.lm_head is None:
            logits = tied_logits(hidden, self.model.embed_tokens)
        elif self.lm_head_quant is not None:
            logits = self.lm_head(*self.lm_head_quant(hidden))
        else:
            logits = self.lm_head(hidden)
        return logits.float()

    @property
    def lm_head_weight(self) -> torch.Tensor:
        """The LM head's (vocab, hidden) weight, tied or owned; sharded by vocabulary, this rank's rows inside the
        vocabulary (``lm_head_vocab`` says which)."""
        if self.lm_head is not None:
            return self.lm_head.weight
        embed = self.model.embed_tokens
        return embed.vocab_rows if isinstance(embed, MojoParallelEmbedding) else embed.weight

    @property
    def lm_head_vocab(self) -> Optional[VocabShard]:
        """The vocab shard ``lm_head_weight`` is, for the loss's ``vocab_shard``: None for a whole head. A tied head
        reads the vocab-parallel embedding's shard; an owned one the shard its style recorded (its logits are
        all-gathered when served, never in the training loss)."""
        if self.lm_head is not None:
            return getattr(self.lm_head, "mojo_vocab_shard", None)
        embed = self.model.embed_tokens
        if isinstance(embed, MojoParallelEmbedding) and (embed.group is not None or embed.num_shards > 1):
            return VocabShard(embed.group, embed.vocab_start, embed.num_embeddings)
        return None

    def train_forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Dense (non-paged) training forward over padded (B, S) ids: the
        final hidden states (B, S, hidden), for
        ``fused_linear_cross_entropy(hidden, lm_head_weight, targets,
        vocab_shard=lm_head_vocab)``. Sharded (``parallel.shard_model``), each
        rank runs its heads and channels with the collectives autograd sees,
        and returns the whole hidden states; ``parallel.training`` completes
        the gradients."""
        return self.model.dense_forward(input_ids)
