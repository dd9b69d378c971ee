"""Builds the program's Qwen3 (dense) or Qwen3-MoE from a configuration file
and writes the benchmark's weights into it.

The weights are drawn on the model's device from the seed, layer by layer,
by ``perfbench.reference.qwen3`` (which draws the same ones again for the
comparison), and copied into the program's parameters: the MoE experts'
gate and up halves into the program's stacked ``(E, 2I, H)`` up projection
(gate first), the router transposed into its ``(H, E)`` gate.
"""

from __future__ import annotations

import torch

from perfbench.reference import qwen3 as reference


def serving_model(cfg: dict, capacity: int, device):
    """The program's model for ``cfg`` with room for ``capacity`` positions
    a sequence, its parameters still as the program drew them."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3MoeConfig, Qwen3MoeForCausalLM

    reference.check_supported(cfg)
    common = dict(
        hidden_size=cfg["hidden_size"], intermediate_size=cfg["intermediate_size"],
        num_attention_heads=cfg["num_attention_heads"], num_key_value_heads=cfg["num_key_value_heads"],
        num_hidden_layers=cfg["num_hidden_layers"], head_dim=cfg["head_dim"], vocab_size=cfg["vocab_size"],
        max_position_embeddings=capacity, rms_norm_eps=cfg["rms_norm_eps"], rope_theta=float(cfg["rope_theta"]),
        attention_bias=cfg.get("attention_bias", False), tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        dtype=getattr(torch, cfg.get("torch_dtype", "bfloat16")),
    )
    if reference.is_moe(cfg):
        return Qwen3MoeForCausalLM(Qwen3MoeConfig(**common, num_experts=cfg["num_experts"],
                                                  num_experts_per_tok=cfg["num_experts_per_tok"],
                                                  moe_intermediate_size=cfg["moe_intermediate_size"]), device=device)
    return Qwen3ForCausalLM(Qwen3Config(**common), device=device)


@torch.no_grad()
def load_weights(model, cfg: dict, seed: int) -> None:
    """Write the benchmark's weights for ``seed`` into ``model``'s parameters."""
    device = next(model.parameters()).device
    moe = reference.is_moe(cfg)
    body = model if moe else model.model  # Qwen3-MoE has no ``model.`` level
    glob = reference.draw_globals(cfg, seed, device)
    body.embed_tokens.weight.copy_(glob["embed_tokens"])
    body.norm.weight.copy_(glob["norm"])
    if "lm_head" in glob:
        model.lm_head.weight.copy_(glob["lm_head"])
    del glob
    for index, layer in enumerate(body.layers):
        w = reference.draw_layer(cfg, seed, index, device)
        attn = layer.self_attn
        pairs = [(layer.input_layernorm.weight, w["input_layernorm"]),
                 (layer.post_attention_layernorm.weight, w["post_attention_layernorm"]),
                 (attn.q_proj.weight, w["q_proj"]), (attn.k_proj.weight, w["k_proj"]),
                 (attn.v_proj.weight, w["v_proj"]), (attn.o_proj.weight, w["o_proj"]),
                 (attn.q_norm.weight, w["q_norm"]), (attn.k_norm.weight, w["k_norm"])]
        if moe:
            I = cfg["moe_intermediate_size"]
            up = layer.mlp.experts.up_proj_weight
            pairs += [(up[:, :I], w["experts_gate"]), (up[:, I:], w["experts_up"]),
                      (layer.mlp.experts.down_proj_weight, w["experts_down"]),
                      (layer.mlp.gating.gate_weight, w["router"].t())]
        else:
            mlp = layer.mlp
            pairs += [(mlp.gate_proj.weight, w["gate_proj"]), (mlp.up_proj.weight, w["up_proj"]),
                      (mlp.down_proj.weight, w["down_proj"])]
        for target, source in pairs:
            if target.shape != source.shape:
                raise ValueError(f"layer {index}: parameter {tuple(target.shape)} != weight {tuple(source.shape)}")
            target.copy_(source)
        del w
