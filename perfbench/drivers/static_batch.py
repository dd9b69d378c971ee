"""Closed loop, one client: each call is one batch through
``MojoGenerator.generate_from_ids`` (stepwise, greedy, ``ignore_eos``) over
``PagedAttentionGenerationModel``, with decode steps on CUDA graphs where
the model runs on the card (the program's default).

Each request has its own output length: the call runs to the longest of
its batch (``max_decode_steps``), and request i is served its first
``outs[i]`` tokens, as a static batch serves requests that stop at
different lengths. The harness's ``GeneratorHook`` stamps the host clock at
each call's start, when its first token reaches the host
(``before_decode``) and when each later token does (the next hook after
each step's ``.cpu()``). A warm-up call of the mix's batch before the
window meets every prompt length of the mix (cuBLAS picks, and loads
lazily, a kernel for each size) and captures the decode graph. The window
opens at the
first timed call and closes on time: the call in flight is ended at its
first step past the close (``WindowClosed`` from the hook), and only tokens
stamped inside count.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel
from mojo_opset_tpu_torch.runtime.generation import GeneratorHook

WARMUP_STEPS = 4  # the decode graph's key runs eagerly, then captures, then replays


class WindowClosed(Exception):
    """Raised by the hook at the first step past the window's close."""


class _NoTokenizer:
    eos_token_id = None


class _Stamps(GeneratorHook):
    def __init__(self, watch, slicer):
        self.watch, self.slicer = watch, slicer
        self.close_at: Optional[float] = None
        self.call: Optional[dict] = None

    def begin(self, call: dict) -> None:
        self.call = call
        if call["index"] >= 0:  # not the warm-up
            self.watch.begin(call["index"], call["lens"], call["outs"])

    def _mark(self, position: int) -> None:
        if self.slicer is not None:
            self.slicer.mark(self.call["index"], position, self.call["lens"], self.call["outs"])

    def _token(self, last: bool = False) -> None:
        t = time.perf_counter()
        c = self.call
        if self.close_at is not None and t > self.close_at:
            if last:
                return
            raise WindowClosed
        c["stamps"].append(t)
        self._mark(len(c["stamps"]))

    def before_prefill(self, *, input_ids, context_input_len):
        self._mark(0)
        self.call["start"] = time.perf_counter()

    def after_prefill(self, *, logits, session):
        self.watch.keep(self.call["index"], 0, logits)

    def before_decode(self):
        self._token()

    def after_decode_step(self, *, step, logits, next_token_id):
        if step > 1:
            self._token()
        self.watch.keep(self.call["index"], step, logits)

    def after_decode(self, *, decode_steps, generated_ids):
        if decode_steps:
            self._token(last=True)
        if self.slicer is not None:
            self.slicer.call_end(self.call["index"], len(self.call["stamps"]))


def drive(model, cfg: dict, mix: dict, traffic, seconds: float, watch, slicer) -> dict:
    """Warm up, then run the window: ``{"t_open", "t_close", "calls", "error"}``,
    each call as ``perfbench.e2e`` and ``perfbench.check`` read it (its
    ``ids``, ``lens`` and, when complete, ``tokens`` too)."""
    served = PagedAttentionGenerationModel(model, block_size=int(cfg["deployment"]["block_size"]))
    hook = _Stamps(watch, None)
    generator = MojoGenerator(served, _NoTokenizer(), GreedySampler(), max_new_tokens=traffic.longest_output,
                              hooks=[hook])
    ids, lens = traffic.warmup()  # every prompt length of the mix, and the decode graph captured
    steps = min(WARMUP_STEPS, traffic.longest_output)
    hook.begin(_new_call(-1, ids, lens, np.full(lens.size, steps)))
    generator.generate_from_ids(ids, lens, max_decode_steps=steps, ignore_eos=True, silent=True)
    if slicer is not None:
        slicer.warm()
    hook.slicer = slicer
    calls, error = [], None
    t_open = time.perf_counter()
    hook.close_at = t_close = t_open + seconds
    k = 0
    while time.perf_counter() < t_close:
        ids, lens, outs = traffic.call(k)
        call = _new_call(k, ids, lens, outs)
        calls.append(call)
        hook.begin(call)
        try:
            out = generator.generate_from_ids(ids, lens, max_decode_steps=int(outs.max()), ignore_eos=True,
                                              silent=True)
        except WindowClosed:
            break
        except Exception as exc:  # the program failed: the run records it and is not correct
            call["failed"] = True
            error = exc
            break
        call["complete"] = len(call["stamps"]) == out.shape[1]
        call["tokens"] = np.asarray(out)
        k += 1
    if slicer is not None:
        slicer.stop()
    return {"t_open": t_open, "t_close": t_close, "calls": calls, "error": error,
            "keep_alive": (generator, served)}


def _new_call(index: int, ids, lens, outs) -> dict:
    return {"index": index, "ids": ids, "lens": np.asarray(lens), "outs": np.asarray(outs), "batch": int(len(lens)),
            "start": None, "stamps": [], "complete": False, "failed": False}
