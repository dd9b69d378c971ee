"""MojoDebugger: rule-driven dual-build precision debugging.

Counterpart of the JAX package's ``utils/debugger.py``: runtime rules
select ops to **dump** (tensors and their statistics, npz files under
``<dump_dir>/rank<N>/``) or to **compare** (run the op's golden ``ref``
twin on the same inputs and log ``max_abs`` / ``max_rel`` / ``cos_sim``),
in ``log`` mode or in ``replace`` mode (the golden output goes on
downstream, which isolates the layer where an error starts).

  * Interception is a global ``nn.Module`` forward hook
    (``torch.nn.modules.module.register_module_forward_hook``), registered
    while the debugger is on and acting on ``MojoOperator``s only. It runs
    after the op's forward pre-hooks and forward, and before the op's own
    forward hooks: a tensor-parallel op's output collective
    (``parallel/styles.py``) still reduces or gathers whatever it returns,
    so the compare sees each rank's partial output against the golden's.
    JAX's counterpart is the ``_DEBUG_HOOKS`` list its ``MojoOperator``
    consults on every call; here the op's call path stays ``nn.Module``'s.
  * The golden shadow is the op's own state under the ``ref`` tier's
    class: it shares the op's parameters and buffers and, on the card,
    runs the golden on the same CUDA tensors (its raw ``forward``, on the
    arguments the op's forward took). Host copies are made only for the
    statistics (four scalars an output) and the dumps. An op that has only
    the golden tier is not run again: a compare rule that matches it
    warns once.
  * Layers are counted by occurrence: the n-th call of an op name within
    a step is layer n; ``new_step()`` resets the counts (``attach`` wires
    it into a ``MojoGenerator``'s hooks).
  * A CUDA graph replays kernels, not Python, so the debugger acts on the
    eager path only: under stream capture the hook does no host work,
    warns once and lets the op run (JAX's counterpart skips under a jit
    tracer).
  * Debugging never breaks the model: an error inside the hook is logged
    and counted (``counts["errors"]``) and the op's own output stands.
    Each compared output appends a record (``records``) and each action
    counts itself (``counts["compare"]``, ``counts["dump"]``), so a
    swallowed error shows as a missing record.

Rules (API or env ``MOJO_DEBUG_COMPARE`` / ``MOJO_DEBUG_DUMP``, re-read
every forward): comma-separated ``"<layer>:<op_name>"`` with ``*`` for
all layers or all ops, e.g. ``"3:RMSNorm"``, ``"*:PagedDecodeGQA"``;
``"none:Gelu"`` vetoes an op whatever else matches.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.nn.modules.module import register_module_forward_hook

from mojo_opset_tpu_torch.core.operator import MojoOperator
from mojo_opset_tpu_torch.utils.logging import get_logger, process_rank, warning_once

logger = get_logger(__name__)


def _parse_rules(spec: Optional[str]):
    rules = []
    if not spec:
        return rules
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            layer, op = part.split(":", 1)
        else:
            layer, op = "*", part
        rules.append((layer.strip(), op.strip()))
    return rules


def _matches(rules, layer_idx: int, op_name: str) -> bool:
    # "none:<op>" rules veto regardless of ordering: exclusion wins over
    # any positive rule, "*:*" included
    for layer, op in rules:
        if layer == "none" and (op == "*" or op == op_name):
            return False
    for layer, op in rules:
        if layer == "none":
            continue
        op_ok = op == "*" or op == op_name
        layer_ok = layer == "*" or (layer.isdigit() and int(layer) == layer_idx)
        if op_ok and layer_ok:
            return True
    return False


def _capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph (never without
    an initialized CUDA context)."""
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _leaves(x) -> list:
    """The tensors of an op's output, in order (tuples, lists and dicts
    flattened; anything else dropped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for item in x for t in _leaves(item)]
    if isinstance(x, dict):
        return [t for key in x for t in _leaves(x[key])]
    return []


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()  # npz keeps fp32 in their place
    return t.cpu().numpy()


class MojoDebugger:
    _handle = None  # the global forward hook's handle while enabled

    dump_dir: str = "mojo_debug_dump"
    compare_mode: str = "log"  # "log" | "replace"
    compare_rules: list = []
    dump_rules: list = []
    _call_counts: dict = {}
    records: list = []  # one dict per compared output: op, layer, out, max_abs, max_rel, cos_sim, ref_max, dtype
    counts: dict = {"compare": 0, "dump": 0, "errors": 0}

    # -- lifecycle -----------------------------------------------------
    @classmethod
    def enable(
        cls,
        dump_dir: Optional[str] = None,
        compare: Optional[str] = None,
        dump: Optional[str] = None,
        compare_mode: str = "log",
    ):
        """Turn the hook on with these rules; ``records`` and ``counts``
        start empty."""
        if dump_dir is not None:
            cls.dump_dir = dump_dir
        cls.compare_rules = _parse_rules(compare)
        cls.dump_rules = _parse_rules(dump)
        cls.compare_mode = compare_mode
        cls.records = []
        cls.counts = {"compare": 0, "dump": 0, "errors": 0}
        if cls._handle is None:
            cls._handle = register_module_forward_hook(cls._on_forward, with_kwargs=True)
        logger.info("MojoDebugger enabled (compare=%s dump=%s mode=%s)", compare, dump, compare_mode)

    @classmethod
    def enabled(cls) -> bool:
        return cls._handle is not None

    @classmethod
    def disable(cls):
        """Turn the hook off; ``records`` and ``counts`` stay for the caller."""
        if cls._handle is not None:
            cls._handle.remove()
            cls._handle = None
        cls._call_counts.clear()

    @classmethod
    def new_step(cls):
        """Reset per-step occurrence counters (call between forwards)."""
        cls._call_counts.clear()

    @classmethod
    def attach(cls, generator):
        """Wire new_step() into a MojoGenerator's hook bus."""
        from mojo_opset_tpu_torch.runtime.generation import GeneratorHook

        class _StepHook(GeneratorHook):
            # reset before and after each forward so every prefill/decode
            # step counts its ops from layer 0
            def before_prefill(self, **kw):
                cls.new_step()

            def after_prefill(self, **kw):
                cls.new_step()

            def after_decode_step(self, **kw):
                cls.new_step()

        generator._hooks.append(_StepHook())
        return generator

    # -- shadow construction -------------------------------------------
    @classmethod
    def _shadow_of(cls, op):
        """Golden (ref-tier) twin sharing the op's exact parameters."""
        ref_cls = type(op).get_registry().get("ref")
        if type(op) is ref_cls:
            return None
        shadow = object.__new__(ref_cls)
        shadow.__dict__.update(vars(op))
        return shadow

    # -- the hook -------------------------------------------------------
    @classmethod
    def _on_forward(cls, op, args, kwargs, output):
        """Global forward hook: None keeps the op's output, anything else
        replaces it (``replace`` mode)."""
        if not isinstance(op, MojoOperator):
            return None
        try:
            if _capturing():
                warning_once(logger, "MojoDebugger: ops called under CUDA graph capture; a replay runs no "
                                     "Python, so debug actions need the eager path: skipping")
                return None
            compare_rules = cls.compare_rules + _parse_rules(os.environ.get("MOJO_DEBUG_COMPARE"))
            dump_rules = cls.dump_rules + _parse_rules(os.environ.get("MOJO_DEBUG_DUMP"))
            if not compare_rules and not dump_rules:
                return None

            op_name = type(op).get_registry().operator_name
            layer_idx = cls._call_counts.get(op_name, 0)
            cls._call_counts[op_name] = layer_idx + 1

            if _matches(dump_rules, layer_idx, op_name):
                cls._dump(op_name, layer_idx, args, kwargs, output)

            if _matches(compare_rules, layer_idx, op_name):
                shadow = cls._shadow_of(op)
                if shadow is None:
                    warning_once(logger, "[debug] %s: op is already the golden tier; not compared", op_name)
                else:
                    ref_out = shadow.forward(*args, **kwargs)
                    cls._log_compare(op_name, layer_idx, output, ref_out)
                    if cls.compare_mode == "replace":
                        return ref_out
            return None
        except Exception as exc:  # debug must never break the model
            cls.counts["errors"] += 1
            logger.warning("MojoDebugger error (swallowed): %r", exc)
            return None  # the op's own output stands

    # -- actions ---------------------------------------------------------
    @classmethod
    def _dump(cls, op_name, layer_idx, args, kwargs, result):
        out_dir = Path(cls.dump_dir) / f"rank{process_rank()}"
        out_dir.mkdir(parents=True, exist_ok=True)
        # the dump's own number keeps two dumps within a millisecond apart
        stamp = f"{op_name}_L{layer_idx}_{int(time.time() * 1e3) % 10**9}_{cls.counts['dump']}"
        payload = {}
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                payload[f"in{i}"] = _host(a)
            elif isinstance(a, np.ndarray):
                payload[f"in{i}"] = a
        for i, leaf in enumerate(_leaves(result)):
            payload[f"out{i}"] = _host(leaf)
        np.savez(out_dir / f"{stamp}.npz", **payload)
        cls.counts["dump"] += 1
        stats = {
            k: (float(np.mean(np.abs(v))), float(np.max(np.abs(v))))
            for k, v in payload.items()
            if np.issubdtype(v.dtype, np.floating) and v.size
        }
        logger.info("[debug dump] %s -> %s stats(mean|max abs)=%s", stamp, out_dir, stats)

    @classmethod
    def _log_compare(cls, op_name, layer_idx, result, ref_out):
        for i, (g, r) in enumerate(zip(_leaves(result), _leaves(ref_out))):
            dtype = g.dtype
            g = g.detach().float()
            r = r.detach().to(g.device).float()
            if g.numel():
                diff = (g - r).abs()
                max_abs = diff.max()
                max_rel = (diff / r.abs().clamp_min(1e-12)).max()
                gf, rf = g.reshape(-1), r.reshape(-1)
                cos = torch.dot(gf, rf) / (gf.norm() * rf.norm() + 1e-12)
                stats = torch.stack([max_abs, max_rel, cos, r.abs().max()]).cpu()
                max_abs, max_rel, cos, ref_max = (float(v) for v in stats)
            else:
                max_abs = max_rel = cos = ref_max = 0.0
            cls.records.append(dict(op=op_name, layer=layer_idx, out=i, max_abs=max_abs, max_rel=max_rel,
                                    cos_sim=cos, ref_max=ref_max, dtype=str(dtype).replace("torch.", "")))
            cls.counts["compare"] += 1
            logger.info(
                "[debug compare] %s layer %d out%d: max_abs=%.3e max_rel=%.3e cos_sim=%.6f",
                op_name, layer_idx, i, max_abs, max_rel, cos,
            )
