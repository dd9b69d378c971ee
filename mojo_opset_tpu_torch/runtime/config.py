"""Runtime configuration (counterpart of the JAX package's ``runtime/config.py``).

The fields the serving slice reads; dtypes are torch dtypes.
``MojoRunTimeConfig`` keeps the JAX package's fields, names and defaults
(:125-143); of them the port reads ``use_device_graph``: the serving entry
points (``PagedAttentionGenerationModel``, ``FusedDecode``,
``SpeculativeDecoder``, the continuous batchers) replay their decode steps
from CUDA graphs when the caller passes no ``device_graph`` and the model's
config sets it. The port's models set it (their ``to_mojo``); the
dataclass default stays JAX's ``False``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class MojoModelConfig:
    hidden_size: int = 0
    head_dim: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    num_layers: int = 0

    vocab_size: int = 0
    max_position_embeddings: int = 2048

    model_name: str = ""
    dtype: torch.dtype = torch.bfloat16

    # paged-cache layout: "NHD" (N, bs, Hkv, D) or "HND" (N, Hkv, bs, D)
    kv_layout: str = "NHD"
    # int8 (C8) KV cache with per-layer (Hkv, D) fp32 channel scales; forces HND
    kv_cache_quant: bool = False

    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    intermediate_size: int = 0

    # mixture of experts: experts, experts per token, width of one expert's FFN
    moe_expert_num: int = 0
    moe_topk: int = 0
    moe_ffn_internal_dim: int = 0

    tie_word_embeddings: bool = False

    # model-specific fields (DeepSeek's MLA: kv_lora_rank, qk_rope_head_dim)
    extra: dict = field(default_factory=dict)


@dataclass
class MojoRunTimeConfig:
    preshard_only: bool = False
    is_deterministic: bool = False

    use_device_graph: bool = False  # decode steps replayed from CUDA graphs (runtime/compile_cache.py)
    use_paged_attention: bool = False
    use_mtp: bool = False
    mtp_draft_recurrent: bool = False

    max_batch_size: int = 16
    max_length: int = 2048
    max_total_tokens: int = 0
    max_num_pred_tokens: int = -1

    num_pages: int = 32
    page_block_size: int = 256

    vanilla_checkpoint_path: Optional[str] = None
    preshard_checkpoint_path: Optional[str] = None


@dataclass
class MojoConfig:
    model_config: Optional[MojoModelConfig] = None
    runtime_config: MojoRunTimeConfig = field(default_factory=MojoRunTimeConfig)
