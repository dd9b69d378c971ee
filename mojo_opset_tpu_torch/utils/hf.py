"""Hugging Face checkpoints: the safetensors reader and the loading pipeline.

Counterpart of the JAX package's ``utils/hf.py``: ``load_sharded_safetensors``
(:111), ``load_state_dict`` (:53), ``strip_prefix_hook`` (:137),
``build_model_from_hf`` (:147), the config converters (:180-307),
``stack_hf_moe_experts`` (:253) and DeepSeek-V3's interleave converters
(:310-343). The port's modules are named after the HF layout, so
``nn.Module.state_dict()`` has the checkpoint's keys and most tensors map
one to one; rename hooks and converters take care of the rest. JAX's
``normalize_path`` and ``state_dict_of`` turn a pytree into such names; the
port has no counterpart, since ``state_dict()`` already gives them
(``utils/weights.py``).

The reader parses the safetensors format itself (an 8-byte little-endian
header length, a JSON header, the tensors' raw bytes) and maps each tensor
from the file, so a bf16 checkpoint stays bf16 and is never copied on the
host: ``load_state_dict`` copies each mapped view straight into its
parameter (``copy_`` casts and moves it to the parameter's device). Neither
``safetensors`` nor ``transformers`` is needed.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import re
import struct
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mojo_opset_tpu_torch.utils.logging import get_logger
from mojo_opset_tpu_torch.utils.weights import IGNORED_SUFFIXES as _WEIGHTS_IGNORED

logger = get_logger(__name__)

# buffers never loaded from checkpoints: recomputed at construction
IGNORED_SUFFIXES = tuple(dict.fromkeys(_WEIGHTS_IGNORED + (
    "inv_freq", "cos", "sin", "codebook", "oe_vocab_sizes", "oe_grams", "oe_vocab_offsets")))

# the safetensors dtypes the reader takes; any other (F8_E4M3, F64, ...) raises
SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of one ``.safetensors`` file as CPU tensors that view the
    file through a copy-on-write map (writable, so ``torch.frombuffer``
    takes it; a write never reaches the file). Each tensor keeps the map
    alive. ``__metadata__`` is skipped; a dtype outside
    ``SAFETENSORS_DTYPES`` raises ``ValueError`` naming the key."""
    with open(path, "rb") as f:
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (header_len,) = struct.unpack("<Q", mapped[:8])
    header = json.loads(mapped[8:8 + header_len])
    base = 8 + header_len  # data offsets count from the end of the header
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {key!r} has dtype {info['dtype']}, which the reader does not take "
                             f"(it takes {', '.join(SAFETENSORS_DTYPES)})")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * dtype.itemsize or base + end > len(mapped):
            raise ValueError(f"{path}: tensor {key!r} spans bytes [{begin}, {end}) for {count} x {info['dtype']}")
        if count == 0:
            out[key] = torch.empty(shape, dtype=dtype)
        else:
            out[key] = torch.frombuffer(mapped, dtype=dtype, count=count, offset=base + begin).view(shape)
    return out


def load_sharded_safetensors(checkpoint_dir: str) -> Dict[str, torch.Tensor]:
    """Load an HF safetensors checkpoint directory
    (``model.safetensors.index.json`` and its shards, or a single
    ``model.safetensors``) as CPU tensors mapped from the files."""
    index_path = os.path.join(checkpoint_dir, "model.safetensors.index.json")
    weights: Dict[str, torch.Tensor] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            index = json.load(f)
        for shard in sorted(set(index["weight_map"].values())):
            weights.update(read_safetensors(os.path.join(checkpoint_dir, shard)))
    else:
        single = os.path.join(checkpoint_dir, "model.safetensors")
        if not os.path.exists(single):
            raise FileNotFoundError(f"no safetensors checkpoint under {checkpoint_dir}")
        weights.update(read_safetensors(single))
    logger.info("loaded %d tensors from %s", len(weights), checkpoint_dir)
    return weights


@torch.no_grad()
def load_state_dict(
    model: nn.Module,
    weights: Dict[str, torch.Tensor],
    rename_hooks: Optional[List[Callable[[str], Optional[str]]]] = None,
    converters: Optional[Dict[str, Callable[[torch.Tensor], torch.Tensor]]] = None,
    strict: bool = True,
) -> nn.Module:
    """Copy ``weights`` into ``model``'s state in place and return it.

    ``rename_hooks`` map a state name to its checkpoint key (the first that
    returns non-None wins; else the name is the key). ``converters``
    ({name regex: fn(tensor)}) transform a loaded tensor whose state name
    the regex fully matches. A shape mismatch raises ``ValueError``, as
    does a float tensor for an integer parameter (it would be truncated).
    Names that share one tensor (the MLA ops' one ``kv_b_proj``) take one
    copy. With ``strict``, a state entry no key feeds raises ``KeyError``;
    otherwise it keeps its init value, with a warning. Unused checkpoint
    tensors are logged at debug level."""
    rename_hooks = rename_hooks or []
    converters = converters or {}
    loaded, missing, used = set(), [], set()
    for path, target in model.state_dict().items():
        if path.split(".")[-1] in IGNORED_SUFFIXES:
            continue
        shared = (target.data_ptr(), tuple(target.shape), target.dtype) if target.numel() else None
        key = None
        for hook in rename_hooks:
            key = hook(path)
            if key is not None:
                break
        if key is None:
            key = path
        if key not in weights:
            missing.append((path, shared))
            continue
        used.add(key)
        if shared is not None and shared in loaded:
            continue
        val = weights[key]
        if not isinstance(val, torch.Tensor):
            val = _from_numpy(val)
        for pattern, fn in converters.items():
            if re.fullmatch(pattern, path):
                val = fn(val)
        if tuple(val.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {path}: checkpoint {tuple(val.shape)} vs model {tuple(target.shape)}")
        if not target.dtype.is_floating_point and val.dtype != target.dtype:
            raise ValueError(f"{path}: a {val.dtype} tensor for a {target.dtype} parameter")
        target.copy_(val)
        loaded.add(shared)
    missing = [path for path, shared in missing if shared is None or shared not in loaded]
    unexpected = [k for k in weights if k not in used]
    if missing and strict:
        raise KeyError(f"missing weights: {missing[:10]} (+{max(0, len(missing) - 10)} more)")
    if missing:
        logger.warning("load_state_dict: %d params kept their init values", len(missing))
    if unexpected:
        logger.debug("load_state_dict: %d unused checkpoint tensors", len(unexpected))
    return model


def _from_numpy(val) -> torch.Tensor:
    """A numpy array (the JAX package's state dicts hold them) as a tensor."""
    arr = np.asarray(val)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch.from_numpy path
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def strip_prefix_hook(prefix: str) -> Callable[[str], Optional[str]]:
    """Common HF rename: some checkpoints store every state name under an
    extra prefix."""

    def hook(path: str) -> Optional[str]:
        return prefix + path

    return hook


def read_hf_config(checkpoint_dir: str) -> dict:
    """``config.json`` of a checkpoint directory ({} when there is none)."""
    cfg_path = os.path.join(checkpoint_dir, "config.json")
    if not os.path.exists(cfg_path):
        return {}
    with open(cfg_path) as f:
        return json.load(f)


def build_model_from_hf(
    model_ctor: Callable[..., nn.Module],
    checkpoint_dir: str,
    config_translate: Optional[Callable[[dict], object]] = None,
    rename_hooks: Optional[List[Callable[[str], Optional[str]]]] = None,
    converters: Optional[Dict[str, Callable]] = None,
    strict: bool = False,
    preprocess: Optional[Callable[[Dict[str, torch.Tensor], dict], Dict[str, torch.Tensor]]] = None,
    **ctor_kwargs,
) -> nn.Module:
    """Build a model from an HF checkpoint directory: read ``config.json``,
    translate it, construct the model (``ctor_kwargs``: ``device``, where
    None means the card, and ``generator`` for its init draws), then load
    the safetensors into it."""
    cfg_dict = read_hf_config(checkpoint_dir)
    if config_translate is not None:
        model = model_ctor(config_translate(cfg_dict), **ctor_kwargs)
    else:
        model = model_ctor(**ctor_kwargs)
    weights = load_sharded_safetensors(checkpoint_dir)
    if preprocess is not None:
        weights = preprocess(weights, cfg_dict)
    return load_state_dict(model, weights, rename_hooks, converters, strict=strict)


# -- model-specific config translators ---------------------------------


def _dtype_from_hf(name) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}.get(name, torch.bfloat16)


def qwen3_config_from_hf(cfg: dict):
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config

    return Qwen3Config(
        hidden_size=cfg.get("hidden_size", 4096),
        intermediate_size=cfg.get("intermediate_size", 11008),
        num_attention_heads=cfg.get("num_attention_heads", 32),
        num_key_value_heads=cfg.get("num_key_value_heads", 8),
        num_hidden_layers=cfg.get("num_hidden_layers", 32),
        head_dim=cfg.get("head_dim", cfg.get("hidden_size", 4096) // cfg.get("num_attention_heads", 32)),
        vocab_size=cfg.get("vocab_size", 151936),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        attention_bias=cfg.get("attention_bias", False),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=_dtype_from_hf(cfg.get("torch_dtype") or cfg.get("dtype")),
    )


def seed_oss_config_from_hf(cfg: dict):
    from mojo_opset_tpu_torch.modeling.seed_oss import SeedOssConfig

    return SeedOssConfig(
        hidden_size=cfg.get("hidden_size", 4096),
        intermediate_size=cfg.get("intermediate_size", 11008),
        num_attention_heads=cfg.get("num_attention_heads", 32),
        num_key_value_heads=cfg.get("num_key_value_heads", 8),
        num_hidden_layers=cfg.get("num_hidden_layers", 32),
        head_dim=cfg.get("head_dim", 128),
        vocab_size=cfg.get("vocab_size", 100352),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 1e7),
        attention_bias=cfg.get("attention_bias", True),
        attention_out_bias=cfg.get("attention_out_bias", False),
        mlp_bias=cfg.get("mlp_bias", False),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=_dtype_from_hf(cfg.get("torch_dtype") or cfg.get("dtype")),
    )


def qwen3_moe_config_from_hf(cfg: dict):
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeConfig

    return Qwen3MoeConfig(
        hidden_size=cfg.get("hidden_size", 2048),
        intermediate_size=cfg.get("intermediate_size", 6144),
        num_attention_heads=cfg.get("num_attention_heads", 32),
        num_key_value_heads=cfg.get("num_key_value_heads", 4),
        num_hidden_layers=cfg.get("num_hidden_layers", 48),
        head_dim=cfg.get("head_dim", 128),
        vocab_size=cfg.get("vocab_size", 151936),
        max_position_embeddings=cfg.get("max_position_embeddings", 40960),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        attention_bias=cfg.get("attention_bias", False),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        num_experts=cfg.get("num_experts", 128),
        num_experts_per_tok=cfg.get("num_experts_per_tok", 8),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 768),
        dtype=_dtype_from_hf(cfg.get("torch_dtype") or cfg.get("dtype")),
    )


def stack_hf_moe_experts(weights: Dict[str, torch.Tensor], num_experts: int) -> Dict[str, torch.Tensor]:
    """The fused expert tensors the port stores, from HF's per-expert
    Linear weights:

      mlp.experts.{e}.gate_proj/up_proj (I, H) -> mlp.experts.up_proj_weight (E, 2I, H)
      mlp.experts.{e}.down_proj (H, I)         -> mlp.experts.down_proj_weight (E, H, I)
      mlp.gate.weight (E, H)                   -> mlp.gating.gate_weight (H, E)

    The per-expert keys are consumed, so they do not show up as unused
    tensors. The stacks are host copies in the checkpoint's dtype."""
    out = dict(weights)
    prefixes = sorted({k.rsplit(".experts.", 1)[0] for k in weights if ".experts." in k and ".gate_proj." in k})
    for p in prefixes:
        gates, ups, downs = [], [], []
        for e in range(num_experts):
            gates.append(out.pop(f"{p}.experts.{e}.gate_proj.weight"))
            ups.append(out.pop(f"{p}.experts.{e}.up_proj.weight"))
            downs.append(out.pop(f"{p}.experts.{e}.down_proj.weight"))
        out[f"{p}.experts.up_proj_weight"] = torch.stack([torch.cat([g, u], dim=0) for g, u in zip(gates, ups)])
        out[f"{p}.experts.down_proj_weight"] = torch.stack(downs)
        gate_w = out.pop(f"{p}.gate.weight", None)
        if gate_w is not None:
            out[f"{p}.gating.gate_weight"] = gate_w.T
    return out


def deepseek_v3_config_from_hf(cfg: dict):
    from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3Config

    return DeepseekV3Config(
        hidden_size=cfg.get("hidden_size", 7168),
        intermediate_size=cfg.get("intermediate_size", 18432),
        moe_intermediate_size=cfg.get("moe_intermediate_size", 2048),
        num_attention_heads=cfg.get("num_attention_heads", 128),
        num_hidden_layers=cfg.get("num_hidden_layers", 61),
        vocab_size=cfg.get("vocab_size", 129280),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 10000.0),
        q_lora_rank=cfg.get("q_lora_rank", 1536),
        kv_lora_rank=cfg.get("kv_lora_rank", 512),
        qk_rope_head_dim=cfg.get("qk_rope_head_dim", 64),
        qk_nope_head_dim=cfg.get("qk_nope_head_dim", 128),
        v_head_dim=cfg.get("v_head_dim", 128),
        n_routed_experts=cfg.get("n_routed_experts", 256),
        n_shared_experts=cfg.get("n_shared_experts", 1),
        num_experts_per_tok=cfg.get("num_experts_per_tok", 8),
        first_k_dense_replace=cfg.get("first_k_dense_replace", 3),
        tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=_dtype_from_hf(cfg.get("torch_dtype") or cfg.get("dtype")),
    )


def _deinterleave_rows(w: torch.Tensor) -> torch.Tensor:
    """Reorder rope rows [x0, x1, ...] -> [x0, x2, ..., x1, x3, ...] (the
    activation permute HF's ``apply_rotary_pos_emb_interleave`` performs,
    folded into the producing weight so plain rotate-half RoPE matches)."""
    return torch.cat([w[0::2], w[1::2]], dim=0)


def deepseek_v3_interleave_converters(hf_cfg: dict) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """Converters for checkpoints with ``rope_interleave=True`` (the
    DeepSeek-V3 default): de-interleave the weight rows that produce q_pe
    and k_pe so the model's rotate-half RoPE reproduces HF's interleaved
    application exactly."""
    dn = hf_cfg.get("qk_nope_head_dim", 128)
    dr = hf_cfg.get("qk_rope_head_dim", 64)
    dqk = dn + dr

    def fix_q(w: torch.Tensor) -> torch.Tensor:
        # (H * dqk, rank): permute the rope rows of each head
        H = w.shape[0] // dqk
        w = w.reshape(H, dqk, -1)
        w = torch.cat([w[:, :dn], w[:, dn::2], w[:, dn + 1::2]], dim=1)
        return w.reshape(H * dqk, -1)

    def fix_kv_a(w: torch.Tensor) -> torch.Tensor:
        # (kv_lora_rank + dr, hidden): permute the trailing rope rows
        return torch.cat([w[:-dr], _deinterleave_rows(w[-dr:])], dim=0)

    return {
        r"model\.layers\.\d+\.self_attn\.(q_b_proj|q_proj)\.weight": fix_q,
        r"model\.layers\.\d+\.self_attn\.kv_a_proj_with_mqa\.weight": fix_kv_a,
    }
