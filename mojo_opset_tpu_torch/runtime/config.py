"""Runtime configuration (counterpart of the JAX package's ``runtime/config.py``).

The fields the serving slice reads; dtypes are torch dtypes.
``MojoRunTimeConfig`` keeps the JAX package's fields, names and defaults
(:125-143); of them the port reads ``use_device_graph``: the serving entry
points (``PagedAttentionGenerationModel``, ``FusedDecode``,
``SpeculativeDecoder``, the continuous batchers) replay their decode steps
from CUDA graphs when the caller passes no ``device_graph`` and the model's
config sets it. The port's models set it (their ``to_mojo``); the
dataclass default stays JAX's ``False``.

``MojoParallelConfig`` and ``AFDRole`` (JAX :146-209) size the process
groups that ``parallel.mesh`` builds; ``MojoModelConfig.local_num_kv_heads``
(JAX :120) is the kv heads one tensor-parallel rank holds, which the
session sizes its caches by.

``MojoDynamicConfig`` (JAX :32-54), the base of ``MojoModelConfig``, takes
unknown keys as plain attributes through ``from_dict``.
``MojoRunTimeConfig.is_deterministic`` follows ``MOJO_DETERMINISTIC=1``
(``utils.platform.is_deterministic``) when the config is made.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Optional

import torch

from mojo_opset_tpu_torch.utils.platform import is_deterministic


_DTYPE_MAPPING = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _as_dtype(value):
    if isinstance(value, str):
        if value not in _DTYPE_MAPPING:
            raise ValueError(f"unsupported dtype: {value}")
        return _DTYPE_MAPPING[value]
    return value


class MojoDynamicConfig:
    """Config base allowing extra fields: dataclass subclasses gain a
    tolerant constructor, :meth:`from_dict`, whose unknown keys become
    plain attributes instead of raising."""

    @classmethod
    def from_dict(cls, values: dict):
        known = {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
        obj = cls(**{k: v for k, v in values.items() if k in known})
        for k, v in values.items():
            if k not in known:
                setattr(obj, k, v)
        return obj

    def extra_fields(self) -> dict:
        known = {f.name for f in dataclasses.fields(self)} if dataclasses.is_dataclass(self) else set()
        return {k: v for k, v in self.__dict__.items() if k not in known}


@dataclass
class MojoModelConfig(MojoDynamicConfig):
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

    # model-specific fields (DeepSeek's MLA: kv_lora_rank, qk_rope_head_dim; a sharded model's local_num_kv_heads)
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        self.dtype = _as_dtype(self.dtype)

    @property
    def local_num_kv_heads(self) -> int:
        """The kv heads of one tensor-parallel rank's attention (all of them unsharded)."""
        return self.extra.get("local_num_kv_heads", self.num_kv_heads)


@dataclass
class MojoRunTimeConfig:
    preshard_only: bool = False
    is_deterministic: bool = False  # also True whenever MOJO_DETERMINISTIC=1 (__post_init__)

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

    def __post_init__(self):
        self.is_deterministic = self.is_deterministic or is_deterministic()


class AFDRole(Enum):
    """Attention-FFN disaggregation role."""

    ATTN = auto()
    FFN = auto()

    def __str__(self):
        return self.name


@dataclass
class MojoParallelConfig:
    """Sizes of the parallel axes, which ``parallel.mesh`` turns into
    process groups: (pp, dp, sp, tp) over the whole world; under AFD an
    attention group (pp, dp, sp, tp) and an FFN group (pp, ep, tp) side by
    side."""

    AFD_ENABLED: bool = False
    AFD_ROLE: AFDRole = AFDRole.FFN

    PP_SIZE: int = 1

    ATTN_DP_SIZE: int = 1
    ATTN_SP_SIZE: int = 1
    ATTN_TP_SIZE: int = 1
    ATTN_PP_SIZE: int = 1  # AFD_ATTN only

    FFN_EP_SIZE: int = 1
    FFN_TP_SIZE: int = 1
    FFN_PP_SIZE: int = 1  # AFD_FFN only

    USE_ULISSES: bool = True

    def __post_init__(self):
        sizes = (
            self.PP_SIZE, self.ATTN_DP_SIZE, self.ATTN_SP_SIZE, self.ATTN_TP_SIZE,
            self.ATTN_PP_SIZE, self.FFN_EP_SIZE, self.FFN_TP_SIZE, self.FFN_PP_SIZE,
        )
        if any(s <= 0 for s in sizes):
            raise ValueError("All parallel sizes must be positive integers")

    @property
    def world_size(self) -> int:
        if not self.AFD_ENABLED:
            return self.ATTN_DP_SIZE * self.ATTN_SP_SIZE * self.ATTN_TP_SIZE * self.PP_SIZE
        return self.attn_world_size + self.ffn_world_size

    @property
    def attn_world_size(self) -> int:
        if not self.AFD_ENABLED:
            raise ValueError("ATTN world size is not defined when AFD is disabled")
        return self.ATTN_DP_SIZE * self.ATTN_SP_SIZE * self.ATTN_TP_SIZE * self.ATTN_PP_SIZE

    @property
    def ffn_world_size(self) -> int:
        if not self.AFD_ENABLED:
            raise ValueError("FFN world size is not defined when AFD is disabled")
        return self.FFN_EP_SIZE * self.FFN_TP_SIZE * self.FFN_PP_SIZE


@dataclass
class MojoConfig:
    model_config: Optional[MojoModelConfig] = None
    parallel_config: MojoParallelConfig = field(default_factory=MojoParallelConfig)
    runtime_config: MojoRunTimeConfig = field(default_factory=MojoRunTimeConfig)


def sharded_config(config: MojoConfig, model) -> MojoConfig:
    """``config`` with what sharding ``model`` changed: the parallel sizes
    and the local kv heads that ``parallel`` recorded on it
    (``model.mojo_parallel``); unchanged for a model never sharded."""
    info = getattr(model, "mojo_parallel", None)
    if info is not None:
        config.parallel_config = info["parallel_config"]
        if info["local_num_kv_heads"] is not None:
            config.model_config.extra["local_num_kv_heads"] = info["local_num_kv_heads"]
    return config
