"""Sharding plans: path patterns to JAX-style specs, applied with explicit collectives.

Counterpart of the JAX package's ``parallel/plans.py`` (``ShardRule`` :28,
``shard_model`` :37, ``qwen3_tp_rules`` :81, ``moe_ep_rules`` :119). The
rules are JAX's, word for word: a parameter whose path matches a rule's
pattern gets its spec, the first match wins, and a spec whose axis does not
divide the dimension falls back to replication with a warning (:56-70).

JAX hands the specs to GSPMD. ``shard_model`` reads them as the port's
styles (``parallel.styles``) and places each collective itself: an
attention block whose ``q_proj`` is split goes by whole heads
(``shard_attention``; ``o_proj`` must then be split on its input, as the
rules split it); a block with a row-split projection is Megatron's MLP
(``shard_mlp``); a split embedding becomes a ``MojoParallelEmbedding``;
the LM head (a projection named ``lm_head``) gathers its logits; split
expert tensors make the MoE expert-parallel. A rule that matches a
parameter none of these takes raises, rather than shard a weight whose
module would not know it.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, List, NamedTuple, Tuple

from torch import nn

from mojo_opset_tpu_torch.core.operators.embedding import MojoEmbedding
from mojo_opset_tpu_torch.core.operators.gemm import MojoQuantGemm
from mojo_opset_tpu_torch.core.operators.moe import MojoMoE, MojoQuantMoE
from mojo_opset_tpu_torch.parallel.mesh import MojoMesh
from mojo_opset_tpu_torch.parallel.styles import (
    LINEAR,
    axis_of,
    colwise,
    is_attention,
    record_parallel,
    replace_module,
    rowwise,
    shard_attention,
    shard_embedding,
    shard_mlp,
)
from mojo_opset_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class ShardRule(NamedTuple):
    pattern: str  # fnmatch over the parameter's path, e.g. "*self_attn.q_proj.weight"
    spec: Tuple  # an axis name or None per dimension


def _spec(name: str, param, rules: List[ShardRule], mesh: MojoMesh) -> tuple:
    """The rule's spec for ``param`` (``()`` when no rule matches, or, with a warning, when it cannot split)."""
    spec = next((tuple(r.spec) for r in rules if fnmatch.fnmatch(name, r.pattern)), ())
    if not any(a is not None for a in spec):
        return ()
    if len(spec) > param.ndim:
        logger.warning("shard_model: %s rank %d < spec %s; replicating", name, param.ndim, spec)
        return ()
    for dim, axis in enumerate(spec):
        if axis is not None and (axis not in mesh.shape or param.shape[dim] % mesh.size(axis)):
            logger.warning("shard_model: %s shape %s not divisible on axis %r; replicating", name,
                           tuple(param.shape), axis)
            return ()
    return spec


def _out_dim(op: nn.Module) -> int:
    """The weight dim of a linear op's output channels (its storage: (out, in), or a QuantGemm's (in, out))."""
    return 1 if isinstance(op, MojoQuantGemm) and not op.trans_weight else 0


def _split(specs: Dict[str, tuple], name: str, dim: int):
    spec = specs.get(name, ())
    return spec[dim] if len(spec) > dim else None


def shard_model(model: nn.Module, mesh: MojoMesh, rules: List[ShardRule]) -> nn.Module:
    """Shard ``model`` in place by ``rules`` on ``mesh``; returns it, its
    config now naming the parallel sizes and one rank's kv heads."""
    specs = {n: _spec(n, p, rules, mesh) for n, p in model.named_parameters()}
    split = {n for n, s in specs.items() if s}
    done = set()

    def owns(prefix, names):
        done.update(n for n in split if n.startswith(prefix) and n[len(prefix):] in names)

    def linear_names(child):
        return (f"{child}.weight", f"{child}.bias", f"{child}.weight_scale")

    for name, module in list(model.named_modules()):
        p = f"{name}." if name else ""
        if is_attention(module):
            axis = _split(specs, p + "q_proj.weight", _out_dim(module.q_proj))
            if axis is not None:
                if _split(specs, p + "o_proj.weight", 1 - _out_dim(module.o_proj)) != axis:
                    raise ValueError(f"shard_model: {name}.q_proj splits its heads over {axis!r}, so o_proj must "
                                     "split its input over the same axis")
                shard_attention(module, *axis_of(mesh, axis))
            owns(p, [n for c in ("q_proj", "k_proj", "v_proj", "o_proj") for n in linear_names(c)])
        elif isinstance(module, (MojoMoE, MojoQuantMoE)):
            experts = sorted(n for n in split if n.startswith(p + "experts."))
            axes = {specs[n][0] for n in experts}
            if len(axes) > 1:
                raise ValueError(f"shard_model: {name}'s experts split over several axes {axes}")
            if axes:
                module.shard_experts(*axis_of(mesh, axes.pop()))
                done.update(experts)
        elif isinstance(module, MojoEmbedding):
            axis = _split(specs, p + "weight", 0)
            if axis is not None:
                replace_module(model, name, shard_embedding(module, *axis_of(mesh, axis)))
                done.add(p + "weight")
        else:
            children = [(c, m) for c, m in module.named_children() if isinstance(m, LINEAR)]
            row = [(c, _split(specs, f"{p}{c}.weight", 1 - _out_dim(m))) for c, m in children]
            row = [(c, a) for c, a in row if a is not None]
            if row:
                axis = row[0][1]
                col = [c for c, m in children if _split(specs, f"{p}{c}.weight", _out_dim(m)) == axis]
                shard_mlp(module, *axis_of(mesh, axis), col=col, row=[c for c, _ in row])
                for c in col + [c for c, _ in row]:
                    owns(p, linear_names(c))
    for name, module in list(model.named_modules()):
        p = f"{name}." if name else ""
        if isinstance(module, LINEAR) and p + "weight" in split and p + "weight" not in done:
            axis = _split(specs, p + "weight", _out_dim(module))
            if axis is not None:
                colwise(module, *axis_of(mesh, axis), gather_output=name.rpartition(".")[2] == "lm_head")
            else:
                rowwise(module, *axis_of(mesh, _split(specs, p + "weight", 1 - _out_dim(module))))
            owns(p, ("weight", "bias", "weight_scale"))
    left = sorted(split - done)
    if left:
        raise NotImplementedError(f"shard_model: no style takes the split parameters {left[:10]}")
    return record_parallel(model, mesh)


def qwen3_tp_rules(tp_axis: str = "tp") -> List[ShardRule]:
    """Megatron-style TP plan for Qwen3 (weights stored (out, in)):
    column-parallel q/k/v, gate/up, the embedding and the LM head;
    row-parallel o_proj and down_proj; the w8a8 channel scales follow the
    column-parallel weights, the row-parallel scales stay whole."""
    return [
        ShardRule("*q_proj.weight", (tp_axis, None)),
        ShardRule("*k_proj.weight", (tp_axis, None)),
        ShardRule("*v_proj.weight", (tp_axis, None)),
        ShardRule("*q_proj.bias", (tp_axis,)),
        ShardRule("*k_proj.bias", (tp_axis,)),
        ShardRule("*v_proj.bias", (tp_axis,)),
        ShardRule("*o_proj.weight", (None, tp_axis)),
        ShardRule("*gate_proj.weight", (tp_axis, None)),
        ShardRule("*up_proj.weight", (tp_axis, None)),
        ShardRule("*down_proj.weight", (None, tp_axis)),
        ShardRule("*embed_tokens.weight", (tp_axis, None)),
        ShardRule("*lm_head.weight", (tp_axis, None)),
        ShardRule("*q_proj.weight_scale", (tp_axis,)),
        ShardRule("*k_proj.weight_scale", (tp_axis,)),
        ShardRule("*v_proj.weight_scale", (tp_axis,)),
        ShardRule("*gate_proj.weight_scale", (tp_axis,)),
        ShardRule("*up_proj.weight_scale", (tp_axis,)),
        ShardRule("*lm_head.weight_scale", (tp_axis,)),
        ShardRule("*self_attn.q_bias", (tp_axis,)),
        ShardRule("*self_attn.k_bias", (tp_axis,)),
        ShardRule("*self_attn.v_bias", (tp_axis,)),
    ]


def moe_ep_rules(ep_axis: str = "ep") -> List[ShardRule]:
    """Expert-parallel plan: expert-major tensors split on dim 0, the quant
    and smooth scales included (scoped under ``experts`` paths, so the
    attention's 1-D channel scales never match)."""
    return [
        ShardRule("*experts*weight", (ep_axis, None, None)),
        ShardRule("*experts*scale", (ep_axis, None)),
    ]
