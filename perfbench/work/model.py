"""Operations of a model step, worked out from a configuration's sizes and
the sequences' lengths. They count what the inputs need, whatever runs
them: 2 operations a multiply-add; each token through every projection's
weights once (a MoE token through the router and ``num_experts_per_tok``
experts, whichever they are); attention over each sequence's own
positions (causal in prefill); the LM head on the rows it scores."""

from __future__ import annotations

from typing import Iterable

import numpy as np


def _moe(cfg: dict) -> bool:
    return int(cfg.get("num_experts", 0) or 0) > 0


def layer_params(cfg: dict) -> int:
    """Weights one token multiplies through in one decoder layer."""
    H, D = cfg["hidden_size"], cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = H * Hq * D * 2 + H * Hkv * D * 2  # q and o; k and v
    if _moe(cfg):
        mlp = H * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * H * cfg["moe_intermediate_size"]
    else:
        mlp = 3 * H * cfg["intermediate_size"]
    return attn + mlp


def head_params(cfg: dict) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def attention_ops_per_key(cfg: dict) -> int:
    """QK and PV for one query row against one key, over every head and layer."""
    return 4 * cfg["num_attention_heads"] * cfg["head_dim"] * cfg["num_hidden_layers"]


def decode_step_ops(cfg: dict, contexts: Iterable[int]) -> float:
    """One decode step of a batch whose sequences attend to ``contexts`` keys
    (the new token's included): every row through the layers and the head."""
    contexts = np.asarray(list(contexts), np.float64)
    per_token = 2.0 * (layer_params(cfg) * cfg["num_hidden_layers"] + head_params(cfg))
    return per_token * contexts.size + attention_ops_per_key(cfg) * float(contexts.sum())


def prefill_ops(cfg: dict, lengths: Iterable[int]) -> float:
    """Prefill of whole prompts of ``lengths``: each token through the
    layers, causal attention (row i sees i + 1 keys), the head on each
    prompt's last row."""
    s = np.asarray(list(lengths), np.float64)
    layers = 2.0 * layer_params(cfg) * cfg["num_hidden_layers"] * float(s.sum())
    attention = attention_ops_per_key(cfg) * float((s * (s + 1) / 2).sum())
    return layers + attention + 2.0 * head_params(cfg) * s.size


def decode_contexts(window: dict, served_only: bool = False) -> list:
    """The keys each row attends to at each decode step of a traced window
    (positions ``from`` to ``to``: the steps that bring tokens ``from`` + 1 ..
    ``to``; token t's step attends to the prompt and t - 1 tokens). With
    ``served_only``, only the rows whose request still wants token t."""
    lens, outs = np.asarray(window["lens"]), np.asarray(window["outs"])
    steps = []
    for t in range(int(window["from"]) + 1, int(window["to"]) + 1):
        rows = outs >= t if served_only else np.ones(lens.size, bool)
        steps.append((lens[rows] + t - 1).tolist())
    return steps


def decode_steps(part: dict) -> int:
    """Decode steps in a traced part's windows."""
    return sum(int(w["to"]) - int(w["from"]) for w in part["windows"])
