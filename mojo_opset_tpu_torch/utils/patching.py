"""Model patching: HF checkpoints into the port's Mojo-op models.

Counterpart of the JAX package's ``utils/patching.py``: each
``apply_mojo_to_*`` builds the port's model from an HF checkpoint (or, for
Wan2.2, from a state dict under the official module names) through
``utils.hf``. Each takes ``device=`` (None: the card) and ``generator=``
(the init draws that the checkpoint then overwrites) where the JAX
package takes ``key=``, and ``strict=`` (default False, as in the JAX
package: a state entry the checkpoint lacks keeps its init value, with a
warning; True raises ``KeyError`` instead). The LLM loaders pass their
other keywords to ``build_model_from_hf``.
"""

from __future__ import annotations

import re
from typing import Optional

import torch

from mojo_opset_tpu_torch.utils.hf import (
    build_model_from_hf,
    deepseek_v3_config_from_hf,
    deepseek_v3_interleave_converters,
    load_state_dict,
    qwen3_config_from_hf,
    qwen3_moe_config_from_hf,
    read_hf_config,
    seed_oss_config_from_hf,
    stack_hf_moe_experts,
)


def _model_prefix_hook(path: str) -> Optional[str]:
    """These models have no ``model.`` wrapper module; the checkpoint
    stores everything but the lm_head under one."""
    return path if path.startswith("lm_head.") else f"model.{path}"


def apply_mojo_to_qwen3(checkpoint_dir: str, device=None, generator: Optional[torch.Generator] = None, **kwargs):
    """The Mojo-op ``Qwen3ForCausalLM`` from an HF Qwen3 checkpoint."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM

    return build_model_from_hf(Qwen3ForCausalLM, checkpoint_dir, config_translate=qwen3_config_from_hf,
                               device=device, generator=generator, **kwargs)


def apply_mojo_to_seed_oss(checkpoint_dir: str, device=None, generator: Optional[torch.Generator] = None, **kwargs):
    """The Mojo-op ``SeedOssForCausalLM`` from an HF Seed-OSS checkpoint."""
    from mojo_opset_tpu_torch.modeling.seed_oss import SeedOssForCausalLM

    return build_model_from_hf(SeedOssForCausalLM, checkpoint_dir, config_translate=seed_oss_config_from_hf,
                               rename_hooks=[_model_prefix_hook], device=device, generator=generator, **kwargs)


def apply_mojo_to_qwen3_moe(checkpoint_dir: str, device=None, generator: Optional[torch.Generator] = None,
                            **kwargs):
    """The Mojo-op ``Qwen3MoeForCausalLM`` from an HF Qwen3-MoE checkpoint,
    the per-expert Linear weights stacked into the fused ``(E, 2I, H)`` /
    ``(E, H, I)`` expert tensors."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeForCausalLM

    return build_model_from_hf(
        Qwen3MoeForCausalLM, checkpoint_dir, config_translate=qwen3_moe_config_from_hf,
        preprocess=lambda w, cfg: stack_hf_moe_experts(w, cfg.get("num_experts", 128)),
        rename_hooks=[_model_prefix_hook], device=device, generator=generator, **kwargs)


def apply_mojo_to_deepseek_v3(checkpoint_dir: str, device=None, generator: Optional[torch.Generator] = None,
                              **kwargs):
    """The Mojo-op ``DeepseekV3ForCausalLM`` from an HF DeepSeek-V3
    checkpoint: (a) the one ``kv_b_proj`` decompression weight, which the
    MLA prefill and decode ops share, and (b) HF's ``rope_interleave=True``
    (also when the config names none) by de-interleaving the rows that
    produce q_pe and k_pe at load time."""
    from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3ForCausalLM

    hf_cfg = read_hf_config(checkpoint_dir)

    def kv_b_hook(path: str) -> Optional[str]:
        m = re.fullmatch(r"(model\.layers\.\d+\.self_attn)\.(attn_prefill|attn_decode)\.kv_b_proj", path)
        return f"{m.group(1)}.kv_b_proj.weight" if m else None

    converters = deepseek_v3_interleave_converters(hf_cfg) if hf_cfg.get("rope_interleave", True) else None
    return build_model_from_hf(DeepseekV3ForCausalLM, checkpoint_dir, config_translate=deepseek_v3_config_from_hf,
                               rename_hooks=[kv_b_hook], converters=converters, device=device, generator=generator,
                               **kwargs)


def wan_dit_rename_hook(path: str) -> Optional[str]:
    """Map ``WanModel`` state names to official Wan2.2 DiT state-dict keys
    (``nn.Sequential`` embeddings, ``ffn.{0,2}`` MLPs)."""
    rules = (
        (r"patch_(weight|bias)", r"patch_embedding.\1"),
        (r"text_in\.(weight|bias)", r"text_embedding.0.\1"),
        (r"text_out\.(weight|bias)", r"text_embedding.2.\1"),
        (r"time_in\.(weight|bias)", r"time_embedding.0.\1"),
        (r"time_out\.(weight|bias)", r"time_embedding.2.\1"),
        (r"time_proj\.(weight|bias)", r"time_projection.1.\1"),
        (r"(blocks\.\d+)\.ffn_in\.(weight|bias)", r"\1.ffn.0.\2"),
        (r"(blocks\.\d+)\.ffn_out\.(weight|bias)", r"\1.ffn.2.\2"),
    )
    for pat, sub in rules:
        if re.fullmatch(pat, path):
            return re.sub(pat, sub, path)
    return None


def apply_mojo_to_wan2_2(dit_state: dict, config=None, device=None, generator: Optional[torch.Generator] = None,
                         strict: bool = False):
    """Load a Wan2.2 DiT state dict (official module naming) into the
    Mojo-op ``WanModel`` (``WanConfig()`` unless ``config`` is given)."""
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig, WanModel

    model = WanModel(config or WanConfig(), device=device, generator=generator)
    return load_state_dict(model, dit_state, rename_hooks=[wan_dit_rename_hook], strict=strict)


def wan_vae_rename_hook(path: str) -> Optional[str]:
    """Map ``WanVAE_`` state names to official Wan2.2 VAE state-dict keys
    (``middle``/``head`` Sequentials, ResidualBlock ``residual.{0,2,3,6}``,
    Down/Up ``downsamples``/``upsamples`` lists whose last entry is the
    stage's Resample: ``<last>``, which ``apply_mojo_to_wan2_2_vae``
    resolves)."""
    rb = (  # ResidualBlock internals
        (r"norm1\.weight$", "residual.0.weight"),
        (r"conv1\.(weight|bias)$", r"residual.2.\1"),
        (r"norm2\.weight$", "residual.3.weight"),
        (r"conv2\.(weight|bias)$", r"residual.6.\1"),
        (r"shortcut\.(weight|bias)$", r"shortcut.\1"),
    )

    def rb_sub(rest: str) -> Optional[str]:
        for pat, sub in rb:
            if re.fullmatch(pat, rest):
                return re.sub(pat, sub, rest)
        return None

    m = re.fullmatch(r"(encoder|decoder)\.mid_block([12])\.(.+)", path)
    if m:
        rest = rb_sub(m.group(3))
        idx = {"1": 0, "2": 2}[m.group(2)]
        return f"{m.group(1)}.middle.{idx}.{rest}" if rest else None
    m = re.fullmatch(r"(encoder|decoder)\.mid_attn\.(.+)", path)
    if m:
        return f"{m.group(1)}.middle.1.{m.group(2)}"
    m = re.fullmatch(r"(encoder|decoder)\.head_norm\.weight", path)
    if m:
        return f"{m.group(1)}.head.0.weight"
    m = re.fullmatch(r"(encoder|decoder)\.head_conv\.(weight|bias)", path)
    if m:
        return f"{m.group(1)}.head.2.{m.group(2)}"
    m = re.fullmatch(r"encoder\.downsamples\.(\d+)\.blocks\.(\d+)\.(.+)", path)
    if m:
        rest = rb_sub(m.group(3))
        return f"encoder.downsamples.{m.group(1)}.downsamples.{m.group(2)}.{rest}" if rest else None
    m = re.fullmatch(r"decoder\.upsamples\.(\d+)\.blocks\.(\d+)\.(.+)", path)
    if m:
        rest = rb_sub(m.group(3))
        return f"decoder.upsamples.{m.group(1)}.upsamples.{m.group(2)}.{rest}" if rest else None
    m = re.fullmatch(r"(encoder\.downsamples|decoder\.upsamples)\.(\d+)\.resample\."
                     r"(conv\.(?:weight|bias)|time_conv\.(?:weight|bias))", path)
    if m:
        seq = "downsamples" if m.group(1).startswith("encoder") else "upsamples"
        leaf = m.group(3).replace("conv.", "resample.1.", 1) if m.group(3).startswith("conv.") else m.group(3)
        return f"{m.group(1)}.{m.group(2)}.{seq}.<last>.{leaf}"
    return None


def apply_mojo_to_wan2_2_vae(vae_state: dict, vae=None, device=None, generator: Optional[torch.Generator] = None,
                             strict: bool = False, **vae_kwargs):
    """Load a Wan2.2 causal-VAE state dict (official naming; ``.gamma``
    norm keys taken as ``.weight``) into ``vae`` or a new Mojo-op
    ``WanVAE_(**vae_kwargs)``."""
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanVAE_

    model = vae if vae is not None else WanVAE_(device=device, generator=generator, **vae_kwargs)
    state = {}
    for k, v in vae_state.items():
        if k.endswith(".gamma"):
            k = k[: -len(".gamma")] + ".weight"
        state[k] = v
    # the Resample module is the highest index in each stage's Sequential
    last_idx = {}
    for k in state:
        m = re.match(r"((?:encoder\.downsamples|decoder\.upsamples)\.\d+\.(?:downsamples|upsamples))\.(\d+)\.", k)
        if m:
            last_idx[m.group(1)] = max(last_idx.get(m.group(1), 0), int(m.group(2)))

    def hook(path: str) -> Optional[str]:
        key = wan_vae_rename_hook(path)
        if key is not None and ".<last>." in key:
            prefix = key.split(".<last>.")[0]
            key = key.replace("<last>", str(last_idx.get(prefix, 0)))
        return key

    return load_state_dict(model, state, rename_hooks=[hook], strict=strict)
