"""Runtime configuration (counterpart of the JAX package's ``runtime/config.py``).

The fields the serving slice reads; dtypes are torch dtypes.
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
class MojoConfig:
    model_config: Optional[MojoModelConfig] = None
