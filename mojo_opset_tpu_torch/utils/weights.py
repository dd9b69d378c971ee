"""Weights: numpy state carried across from the JAX package, and random
full-width initialization on the device.

The keys are those of the JAX package's ``utils.hf.state_dict_of`` (the HF
layout: ``model.layers.N.self_attn.q_proj.weight`` ...); the port's
modules are named so that ``state_dict()`` has the same keys. A w8a8
model's projections carry int8 ``weight`` and fp32 ``weight_scale``
arrays (``state_dict_of(quantize_qwen3(jax_model))``). A w4a8 model's
packed-int4 projections carry int8 ``(N // 2, K)`` arrays in the
``pack_int4_rows`` layout with fp32 ``(N,)`` scales, and its other
projections and the lm_head int8 ``(N, K)``
(``state_dict_of(quantize_qwen3(jax_model, weight_dtype="int4"))`` into a
model built with ``Qwen3Config(quant="w4a8")``). A Qwen3-MoE model has no
``model.`` level, as in the JAX package: ``layers.N.mlp.gating.gate_weight``
(fp32 (H, E)) and ``layers.N.mlp.experts.{up,down}_proj_weight``. A
DeepSeek-V3 model has it: ``model.layers.N.self_attn.{q_a_proj,q_b_proj,
kv_a_proj_with_mqa,o_proj}.weight`` (``q_proj`` without q LoRA),
``{q_a,kv_a}_layernorm.weight``, the fp32 decompression weight under both
``attn_prefill.kv_b_proj`` and ``attn_decode.kv_b_proj`` (one tensor in the
port: the two arrays must be equal), ``mlp.{gate,up,down}_proj.weight`` in
the dense layers and ``mlp.routed_experts.{gating.gate_weight,
experts.up_proj_weight,experts.down_proj_weight}`` with
``mlp.shared_experts.*`` in the MoE layers. A quantized Qwen3-MoE
(``state_dict_of(quantize_qwen3_moe(jax_model, weight_dtype))`` into
``Qwen3MoeConfig(quant="w8a8" | "w4a8")``) carries the dense w8a8 / w4a8
attention projections above, an int8 ``lm_head.weight`` (N, K) with fp32
``lm_head.weight_scale``, and per MoE layer
``layers.N.mlp.experts.{up,down}_proj_weight`` int8 ((E, 2I, H), (E, H, I);
under w4a8 packed two output rows a byte, (E, I, H), (E, H / 2, I), the
experts' own layout, not ``pack_int4_rows``'), fp32
``layers.N.mlp.experts.{up,down}_proj_weight_scale`` ((E, 2I), (E, H)) and
fp32 ``layers.N.mlp.experts.{up,down}_proj_quantize.inv_smooth_scale`` ((E,
H), (E, I)), beside the fp32 gate and the fp norms. A w8a8 DeepSeek-V3
(``state_dict_of(quantize_deepseek_v3(jax_model))`` into
``DeepseekV3Config(quant="w8a8")``) carries int8 ``weight`` and fp32
``weight_scale`` for ``q_a_proj``, ``q_b_proj`` (or ``q_proj``),
``kv_a_proj_with_mqa``, ``o_proj``, the dense and shared MLPs' projections
and the lm_head, the routed experts as the quantized Qwen3-MoE's under
``mlp.routed_experts.experts``, and the fp32 ``kv_b_proj`` under both MLA
ops as before. A Seed-OSS model has no
``model.`` level either: ``layers.N.self_attn.{q,k,v}_proj.bias`` beside
the weights; its w8a8 twin (``state_dict_of(quantize_seed_oss(jax_model))``
into ``SeedOssConfig(quant="w8a8")``) carries int8 projections and the
floating-point ``layers.N.self_attn.{q,k,v,o}_bias`` leaves (``o_bias``
only with ``attention_out_bias``). A Wan DiT (``WanModel``) has the JAX
package's module names: ``patch_weight``, ``patch_bias``,
``{text,time}_{in,out}.{weight,bias}``, ``time_proj.*``,
``blocks.N.{self_attn,cross_attn}.{q,k,v,o}.{weight,bias}``,
``blocks.N.{self_attn,cross_attn}.norm_{q,k}.weight``,
``blocks.N.norm3.{weight,bias}``, ``blocks.N.ffn_{in,out}.*``,
``blocks.N.modulation``, ``head.head.*`` and ``head.modulation``; its complex
RoPE table ``freqs`` is recomputed, not loaded. A single op loads the same
way under the JAX op's names: a norm op's ``weight`` and ``bias``,
``MojoSwiGLUMLP``'s ``fc1.weight`` and ``fc2.weight``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

# buffers recomputed at construction, never loaded
IGNORED_SUFFIXES = ("inv_freq", "freqs")


@torch.no_grad()
def load_numpy_state(model: nn.Module, arrays: Dict[str, np.ndarray], strict: bool = True) -> nn.Module:
    """Copy numpy arrays into ``model``'s parameters (cast to each
    parameter's dtype and device). With ``strict``, a missing or unknown
    key, or a shape mismatch, raises ``KeyError``/``ValueError``. An
    integer parameter (the int8 weights) takes only an array of its own
    dtype: a float array would be truncated. Keys that name one shared
    tensor must carry equal arrays."""
    state = model.state_dict()
    arrays = {k: v for k, v in arrays.items() if k.rsplit(".", 1)[-1] not in IGNORED_SUFFIXES}
    first_name = {}
    for name, tensor in state.items():
        other = first_name.setdefault((tensor.data_ptr(), tensor.shape, tensor.dtype), name)
        if other != name and other in arrays and name in arrays and not np.array_equal(arrays[other], arrays[name]):
            raise ValueError(f"{name} and {other} name one shared tensor, but their arrays differ")
    if strict:
        missing = sorted(set(state) - set(arrays))
        unexpected = sorted(set(arrays) - set(state))
        if missing or unexpected:
            raise KeyError(f"state mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    for name, array in arrays.items():
        if name not in state:
            continue
        target = state[name]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(f"{name}: shape {tuple(array.shape)} != {tuple(target.shape)}")
        if array.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch.from_numpy path
            array = array.astype(np.float32)
        source = torch.tensor(np.asarray(array))
        if not target.dtype.is_floating_point and source.dtype != target.dtype:
            raise ValueError(f"{name}: {source.dtype} array for a {target.dtype} parameter")
        target.copy_(source)
    return model


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every op's weights from ``generator`` on the weights' device,
    with the JAX package's distributions (its ``utils/init.py``):
    U(-1/sqrt(in), 1/sqrt(in)) for GEMMs and the expert stacks (up
    U(+-1/sqrt(H)), down U(+-1/sqrt(I))), N(0, 1) for embeddings, N(0, 0.02)
    for the MoE gate; norm weights stay ones. The bits differ from the JAX
    package's."""
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None and module is not model:
            reset(generator=generator)
    return model
