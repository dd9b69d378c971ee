"""Plain Qwen3 and Qwen3-MoE, and the benchmark's weights for them.

The forward pass follows the published architecture (Hugging Face
transformers' ``Qwen3ForCausalLM`` and ``Qwen3MoeForCausalLM``): token
embedding; per layer an RMSNorm, the q/k/v projections, an RMSNorm over each
head of q and of k, rotate-half RoPE at ``rope_theta``, causal softmax
attention with ``num_key_value_heads`` shared by the query heads in order,
the o projection and the residual, then an RMSNorm and the SwiGLU MLP (or
the router's softmax over all experts, its top ``num_experts_per_tok``,
renormalised where ``norm_topk_prob``, and each chosen expert's SwiGLU
weighted by its gate) and the residual; a final RMSNorm and the LM head,
tied to the embedding where ``tie_word_embeddings``. There is no cache and no
kernel: every sequence's whole prefix at once (the sequences' rows side by
side, attention within each), in float32 with TF32 off.

``precision="fp8"`` is the comparison's control: the same forward with both
operands of every matmul (projections, experts, router, attention's QK and
PV, the LM head) rounded to float8 e4m3 with one scale per row, then
multiplied in float32.

The weights are the benchmark's, drawn here from the seed on the given
device, and so the same wherever they are drawn on that device: one
``torch.Generator`` per layer (and one for the embedding, the final norm
and the head), one draw a group, in the served dtype. Projections,
embedding, head, experts and router are N(0, initializer_range); norm
weights 1 + N(0, 0.1), so that no norm weight is the constant it would
start at. They are returned under Hugging Face's names and layouts;
``perfbench/models/`` writes them into the program's parameters and the
reference draws them again, layer by layer.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

NORM_SPREAD = 0.1
FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def _generator(seed: int, stream: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), 7, int(stream)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _draw(shapes: Dict[str, tuple], std: float, norms: Iterable[str], gen: torch.Generator, device, dtype):
    """One N(0, 1) draw for all ``shapes``, cut into views: the names in
    ``norms`` become 1 + NORM_SPREAD x, the others std x."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    flat = torch.empty(sum(sizes), dtype=dtype, device=device).normal_(generator=gen)
    out, start = {}, 0
    norms = set(norms)
    for (name, shape), n in zip(shapes.items(), sizes):
        piece = flat[start:start + n].view(shape)
        out[name] = piece.mul_(NORM_SPREAD).add_(1.0) if name in norms else piece.mul_(std)
        start += n
    return out


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg.get("torch_dtype", "bfloat16"))


def is_moe(cfg: dict) -> bool:
    return int(cfg.get("num_experts", 0) or 0) > 0


def check_supported(cfg: dict) -> None:
    """Raise on a configuration whose architecture this reference does not compute."""
    wanted = {"hidden_act": "silu", "rope_scaling": None, "use_sliding_window": False, "attention_bias": False}
    if is_moe(cfg):
        wanted.update(decoder_sparse_step=1, mlp_only_layers=[], norm_topk_prob=True)
    odd = {k: cfg.get(k, v) for k, v in wanted.items() if cfg.get(k, v) != v}
    if odd:
        raise ValueError(f"the Qwen3 reference computes {wanted}; this configuration has {odd}")


def draw_globals(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``embed_tokens`` (V, H), ``norm`` (H,) and, untied, ``lm_head`` (V, H)."""
    V, H = cfg["vocab_size"], cfg["hidden_size"]
    shapes = {"embed_tokens": (V, H), "norm": (H,)}
    if not cfg.get("tie_word_embeddings", False):
        shapes["lm_head"] = (V, H)
    return _draw(shapes, cfg["initializer_range"], ["norm"], _generator(seed, 0, device), device, _dtype(cfg))


def draw_layer(cfg: dict, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """One decoder layer's weights under Hugging Face's names and layouts:
    projections (out, in); experts stacked (E, I, H) for gate and up and
    (E, H, I) for down; the router (E, H)."""
    H, D = cfg["hidden_size"], cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    shapes = {
        "input_layernorm": (H,), "q_proj": (Hq * D, H), "k_proj": (Hkv * D, H), "v_proj": (Hkv * D, H),
        "o_proj": (H, Hq * D), "q_norm": (D,), "k_norm": (D,), "post_attention_layernorm": (H,),
    }
    if is_moe(cfg):
        E, I = cfg["num_experts"], cfg["moe_intermediate_size"]
        shapes.update({"router": (E, H), "experts_gate": (E, I, H), "experts_up": (E, I, H),
                       "experts_down": (E, H, I)})
    else:
        I = cfg["intermediate_size"]
        shapes.update({"gate_proj": (I, H), "up_proj": (I, H), "down_proj": (H, I)})
    norms = ("input_layernorm", "q_norm", "k_norm", "post_attention_layernorm")
    return _draw(shapes, cfg["initializer_range"], norms, _generator(seed, layer + 1, device), device, _dtype(cfg))


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row (last dim), back in float32."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Math:
    """The matmuls of one precision: float32, or float8-rounded operands."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.round = _fp8 if precision == "fp8" else (lambda x: x)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w.T`` for x (..., in) and w (out, in)."""
        return torch.matmul(self.round(x), self.round(w).t())

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b.T`` over leading batch dims, rows of both rounded."""
        return torch.matmul(self.round(a), self.round(b).transpose(-1, -2))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on (S, heads, D) at ``positions`` (S,)."""
    D = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64, device=x.device) / D))
    angles = positions.double()[:, None] * inv_freq[None, :]
    emb = torch.cat([angles, angles], dim=-1)
    cos, sin = emb.cos().float()[:, None, :], emb.sin().float()[:, None, :]
    half = D // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rotated * sin


def attention(q, k, v, math: _Math, block: int = 1024) -> torch.Tensor:
    """Causal GQA attention: q (S, Hq, D), k and v (S, Hkv, D) -> (S, Hq, D),
    in query blocks of ``block`` rows so that the scores fit."""
    S, Hq, D = q.shape
    group = Hq // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (Hq, S, D)
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for start in range(0, S, block):
        stop = min(start + block, S)
        scores = math.bmm(q[start:stop].transpose(0, 1), k[:, :stop]) / D**0.5  # (Hq, rows, keys)
        rows = torch.arange(start, stop, device=q.device)[:, None]
        scores = scores.masked_fill(torch.arange(stop, device=q.device)[None, :] > rows, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out[start:stop] = torch.matmul(math.round(probs), math.round(v[:, :stop].transpose(-1, -2)).transpose(-1, -2)
                                       ).transpose(0, 1)
    return out


def _mlp(x, w, math: _Math):
    return math.linear(torch.nn.functional.silu(math.linear(x, w["gate_proj"])) * math.linear(x, w["up_proj"]),
                       w["down_proj"])


def _moe(x, w, cfg: dict, math: _Math):
    probs = torch.softmax(math.linear(x, w["router"]), dim=-1)
    gates, experts = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob", True):
        gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in torch.unique(experts).tolist():
        rows, slot = torch.nonzero(experts == e, as_tuple=True)
        h = x[rows]
        act = torch.nn.functional.silu(math.linear(h, w["experts_gate"][e])) * math.linear(h, w["experts_up"][e])
        out.index_add_(0, rows, math.linear(act, w["experts_down"][e]) * gates[rows, slot, None])
    return out


def _layer(h: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict, math: _Math, bounds, positions) -> torch.Tensor:
    """One decoder layer over the sequences' rows side by side (T, H): attention
    within each sequence (rows ``bounds[i]`` to ``bounds[i + 1]``), the rest row by row."""
    T = h.shape[0]
    eps, D = cfg["rms_norm_eps"], cfg["head_dim"]
    x = rms_norm(h, w["input_layernorm"], eps)
    q = rms_norm(math.linear(x, w["q_proj"]).view(T, -1, D), w["q_norm"], eps)
    k = rms_norm(math.linear(x, w["k_proj"]).view(T, -1, D), w["k_norm"], eps)
    v = math.linear(x, w["v_proj"]).view(T, -1, D)
    q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"])
    o = torch.cat([attention(q[a:b], k[a:b], v[a:b], math) for a, b in zip(bounds[:-1], bounds[1:])])
    h = h + math.linear(o.reshape(T, -1), w["o_proj"])
    x = rms_norm(h, w["post_attention_layernorm"], eps)
    return h + (_moe(x, w, cfg, math) if is_moe(cfg) else _mlp(x, w, math))


def _float(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in weights.items()}


@torch.no_grad()
def forward_logits(cfg: dict, seed: int, sequences: Sequence[torch.Tensor], first_rows: Sequence[int], device,
                   precisions: Sequence[str] = ("fp32",), row_block: int = 256) -> List[Dict[str, torch.Tensor]]:
    """The LM head's float32 logits of each sequence (token ids (S,)) at its
    rows ``first_rows[i]`` to its end, for each precision: a list (one a
    sequence) of ``{precision: (S - first_row, V) float32 on the CPU}``.
    Layer by layer over all sequences at once, each layer's weights drawn once."""
    check_supported(cfg)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        maths = {p: _Math(p) for p in precisions}
        glob = draw_globals(cfg, seed, device)
        embed = glob["embed_tokens"]
        ids = torch.cat([x.to(device).long() for x in sequences])
        lengths = [int(x.numel()) for x in sequences]
        bounds = [0, *np.cumsum(lengths).tolist()]
        positions = torch.cat([torch.arange(n, device=device) for n in lengths])
        hidden = {p: embed[ids].float() for p in precisions}
        for layer in range(cfg["num_hidden_layers"]):
            w = _float(draw_layer(cfg, seed, layer, device))
            for p, math in maths.items():
                hidden[p] = _layer(hidden[p], w, cfg, math, bounds, positions)
            del w
        head = (glob["lm_head"] if "lm_head" in glob else embed).float()
        norm = glob["norm"].float()
        out = []
        for i, first in enumerate(first_rows):
            rows = {}
            for p, math in maths.items():
                h = rms_norm(hidden[p][bounds[i] + first:bounds[i + 1]], norm, cfg["rms_norm_eps"])
                rows[p] = torch.cat([math.linear(h[r:r + row_block], head).cpu()
                                     for r in range(0, h.shape[0], row_block)])
            out.append(rows)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
