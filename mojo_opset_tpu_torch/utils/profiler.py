"""Device profiler hooks on ``torch.profiler``.

Counterpart of the JAX package's ``utils/profiler.py`` (``create_tpu_profiler``,
``TPUProfilerHook``, ``trace_annotation`` on ``jax.profiler``):

  * :class:`CUDAProfilerHook` (JAX's ``TPUProfilerHook``) profiles a window
    of a ``MojoGenerator``'s decode steps: the trace starts after ``wait``
    steps (``wait=0``: before the prefill, which it then covers too) and
    captures ``active`` steps, CPU activity always and CUDA
    activity on the card, then exports a chrome trace (``trace.json``
    under ``log_dir``, one file a window: ``trace_<n>.json``); the device
    is synchronized (``torch.cuda.synchronize``, JAX's ``device_sync``)
    before the trace stops, so the profiled steps have finished;
  * :func:`create_cuda_profiler` (JAX's ``create_tpu_profiler``) returns one;
  * :func:`trace_annotation` (JAX's ``jax.profiler.TraceAnnotation``) is a
    named span in the trace: the runtime's ``utils.tracing.span``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

from mojo_opset_tpu_torch.runtime.generation import GeneratorHook
from mojo_opset_tpu_torch.utils.logging import get_logger
from mojo_opset_tpu_torch.utils.tracing import span

logger = get_logger(__name__)


def profiler_activities(device=None) -> list:
    """CPU activity, and CUDA activity on the card: where ``device`` is a
    CUDA device or, given none, wherever one is available."""
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    return [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])


def create_cuda_profiler(log_dir: str = "mojo_profile", **kwargs) -> "CUDAProfilerHook":
    """The hook to append to a generator's hooks (JAX's ``create_tpu_profiler``)."""
    return CUDAProfilerHook(log_dir, **kwargs)


class CUDAProfilerHook(GeneratorHook):
    """Profile a window of decode steps (JAX's ``TPUProfilerHook``): the
    trace starts after ``wait`` steps and captures ``active`` steps.
    ``activities`` defaults to CPU, plus CUDA where the card is available.
    ``traces`` lists the chrome traces written; ``profile`` is the last
    window's ``torch.profiler.profile`` (its ``key_averages()``)."""

    def __init__(self, log_dir: str = "mojo_profile", wait: int = 2, active: int = 3,
                 activities: Optional[list] = None):
        self.log_dir = log_dir
        self.wait = wait
        self.active = active
        self.activities = activities if activities is not None else profiler_activities()
        self.traces: List[str] = []
        self.profile = None
        self._step = 0
        self._running = False

    def before_prefill(self, **kwargs):
        self._step = 0
        if self.wait == 0 and not self._running:
            self._start()

    def after_decode_step(self, *, step, logits, next_token_id):
        self._step += 1
        if self._step == self.wait and not self._running:
            self._start()
        elif self._running and self._step >= self.wait + self.active:
            self._stop(logits)

    def _start(self) -> None:
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile = torch.profiler.profile(activities=self.activities)
        self.profile.__enter__()
        self._running = True
        logger.info("CUDA profiler trace started -> %s", self.log_dir)

    def after_decode(self, **kwargs):
        if self._running:
            self._stop(None)

    def _stop(self, tail) -> None:
        if isinstance(tail, torch.Tensor) and tail.is_cuda:
            torch.cuda.synchronize(tail.device)
        elif torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.profile.__exit__(None, None, None)
        self._running = False
        name = "trace.json" if not self.traces else f"trace_{len(self.traces)}.json"
        path = os.path.join(self.log_dir, name)
        self.profile.export_chrome_trace(path)
        self.traces.append(path)
        logger.info("CUDA profiler trace saved -> %s", path)


def trace_annotation(name: str):
    """Named span visible in the profiler's trace (JAX's
    ``jax.profiler.TraceAnnotation``): ``utils.tracing.span``."""
    return span(name)
