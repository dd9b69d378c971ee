"""Op timing on the card.

Counterpart of the JAX package's ``benchmark/timing.py`` (``device_sync``
:27, ``device_time_us`` :118, ``profiled_time_us`` :159). A call's time is
the difference of two chains of calls, which cancels what a chain costs
once (a launch, an event pair)::

    per_call = (T(2n) - T(n)) / n        with the best of ``repeats`` per length

and ``n`` doubles until ``T(2n) >= 1.8 T(n)``, the chain passes
``time_budget_s`` or ``2n`` reaches ``max_iters``. On the card a chain is
timed with ``torch.cuda.Event``s. A chain whose calls never wait on the
device from the host is captured in one CUDA graph and replayed, so the
host's launch rate does not pace a microsecond op (timer ``"graph"``); a
call that reads the card back to the host (a count, a length) or that a
capture refuses (a CUDA generator made in the call) is launched eagerly
between the events (timer ``"events"``), the reason logged. Tensors on the CPU are
timed on the host clock (timer ``"host"``), never reported as a device
time. JAX's carry of ``|out| * 1e-30`` (:57-78) stops XLA from eliding the
op under test; eager PyTorch elides nothing, so it is not ported.

``thread_idx`` feeds named outputs back as named arguments on the next
call, as in JAX: an op that writes a cache in place returns it and gets it
back, so a chain never copies the state.

``profiled_time_us`` runs calls under ``torch.profiler`` and reduces the
device kernels whose names match ``fnmatch`` patterns (the CPU op events,
such as ``aten::mm``, on CPU tensors); -1.0 when nothing matched or the
trace lost records, and the chain's time stands.
"""

from __future__ import annotations

import fnmatch
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

from mojo_opset_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (tuple, list)):
        for value in tree:
            yield from _leaves(value)


def device_sync(tree):
    """Wait for the device of every CUDA tensor in ``tree`` (tensors,
    modules' parameters and buffers, nested tuples, lists and dicts); CPU
    tensors need no wait. Returns ``tree``."""
    for device in {leaf.device for leaf in _leaves(tree) if leaf.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


def device_of(tree) -> torch.device:
    """The CUDA device that ``tree`` lives on, else the CPU."""
    return next((leaf.device for leaf in _leaves(tree) if leaf.is_cuda), torch.device("cpu"))


class _Chain:
    """One call of ``fn`` on the chain's arguments a ``step()``;
    ``thread_idx`` pairs (arg position, output position) carry outputs to
    the next call."""

    def __init__(self, fn: Callable, args, thread_idx):
        self.fn, self.state, self.thread_idx = fn, list(args), tuple(thread_idx)

    def step(self):
        out = self.fn(*self.state)
        if self.thread_idx:
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for arg_pos, out_pos in self.thread_idx:
                self.state[arg_pos] = outs[out_pos]
        return out


def capture_reason(chain: _Chain) -> Optional[str]:
    """Why a call of the chain cannot be captured in a CUDA graph, or None:
    the synchronizing operation it makes (PyTorch's sync debug mode, one
    real call), else what a trial capture of one call raised (a new CUDA
    generator, say). The trial's launches are taken off the counters and
    the chain's arguments restored."""
    from mojo_opset_tpu_torch.backends.cuda import kernels

    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain.step()
    except RuntimeError as err:
        if "synchronizing" not in str(err):
            raise
        return str(err).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(previous)
    saved = list(chain.state)
    try:
        with kernels.recorded_counts(), torch.cuda.graph(torch.cuda.CUDAGraph()):
            chain.step()
    except RuntimeError as err:
        return str(err).splitlines()[0]
    finally:
        chain.state = saved
    return None


class _GraphChains:
    """Chains of ``n`` calls captured in one CUDA graph each, replayed
    between events. The capture's kernel launches are taken off the
    launch counters and credited once a replay, as the runtime's graphs do
    (``backends/cuda/kernels.recorded_counts``)."""

    def __init__(self, chain: _Chain, device: torch.device):
        self.step, self.device = chain.step, device
        self.graphs: dict = {}
        self.side = torch.cuda.Stream(device)

    def graph(self, n: int):
        if n not in self.graphs:
            from mojo_opset_tpu_torch.backends.cuda import kernels

            self.side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.side):
                self.step()  # warm-up off the capture
            torch.cuda.current_stream(self.device).wait_stream(self.side)
            graph = torch.cuda.CUDAGraph()
            with kernels.recorded_counts() as record, torch.cuda.graph(graph):
                for _ in range(n):
                    self.step()
            self.graphs = {k: v for k, v in self.graphs.items() if k > n // 2}  # the shorter ones are done
            self.graphs[n] = (graph, record)
        return self.graphs[n]

    def run(self, n: int) -> None:
        from mojo_opset_tpu_torch.backends.cuda import kernels

        graph, record = self.graph(n)
        graph.replay()
        kernels.credit_counts(record)


def chain_seconds(run: Callable, device: torch.device, timer: str) -> float:
    """Seconds ``run()`` takes: on the host clock for ``timer="host"``, else
    between CUDA events on the current stream, waiting for the end one."""
    if timer == "host":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3


def timed_us(fn: Callable, *args, iters: int = 20, repeats: int = 6, warmup: int = 2, max_iters: int = 8192,
             time_budget_s: float = 1.0, thread_idx: Sequence[Tuple[int, int]] = (), device=None,
             graph: Optional[bool] = None, agree: Optional[Callable[[bool], bool]] = None) -> Tuple[float, str]:
    """Time of one call of ``fn(*args)`` in microseconds and the timer that
    took it (``"graph"``, ``"events"`` or ``"host"``). ``device`` defaults to
    the first CUDA tensor's among ``args`` (modules included), else the CPU.
    ``graph=None`` captures the chain unless a call cannot be captured
    (``capture_reason``); ``graph=False`` launches it eagerly. ``agree``
    turns this process's decision to stop doubling into the one every
    process of a group takes, where ``fn`` runs collectives: each rank's
    chains then have one length, so the collectives pair up."""
    device = torch.device(device) if device is not None else device_of(args)
    chain = _Chain(fn, args, thread_idx)
    step = chain.step
    if device.type != "cuda":
        timer = "host"
    else:
        reason = capture_reason(chain) if graph is None else None
        if reason is not None:
            logger.info("%s is timed eagerly between events: a call cannot be captured (%s)",
                        getattr(fn, "__name__", "fn"), reason)
        timer = "graph" if graph is not False and reason is None else "events"
    chains = _GraphChains(chain, device) if timer == "graph" else None

    def best(n: int) -> float:
        if chains is not None:
            run = lambda: chains.run(n)  # noqa: E731
        else:
            def run():
                for _ in range(n):
                    step()
        for _ in range(warmup):
            chain_seconds(run, device, timer)
        return min(chain_seconds(run, device, timer) for _ in range(max(repeats, 1)))

    n = max(1, iters)
    while True:
        t_n = best(n)
        t_2n = best(2 * n)
        per_call = (t_2n - t_n) / n
        stop = per_call > 0 and (t_2n >= 1.8 * t_n or t_n > time_budget_s)
        if agree(stop) if agree is not None else stop:
            break
        if 2 * n >= max_iters:
            break
        n *= 2
    return max(per_call * 1e6, 1e-3), timer


def device_time_us(fn: Callable, *args, iters: int = 20, repeats: int = 6, warmup: int = 2, max_iters: int = 8192,
                   time_budget_s: float = 1.0, thread_idx: Sequence[Tuple[int, int]] = (), device=None) -> float:
    """Time of one call of ``fn(*args)`` in microseconds (``timed_us``
    without the timer's name)."""
    return timed_us(fn, *args, iters=iters, repeats=repeats, warmup=warmup, max_iters=max_iters,
                    time_budget_s=time_budget_s, thread_idx=thread_idx, device=device)[0]


def _kernel_name(name: str) -> str:
    """A kernel's name without the ``void`` a template kernel's demangled
    name starts with and the ``(anonymous namespace)::`` of a kernel in one
    (``void (anonymous namespace)::paged_decode_kernel<...>`` ->
    ``paged_decode_kernel<...>``)."""
    name = name[5:] if name.startswith("void ") else name
    return name.replace("(anonymous namespace)::", "")


def _matcher(kernels, match: str) -> Callable[[str], bool]:
    pats = list(kernels) if kernels else ["*"]

    def matches(name: str) -> bool:
        hits = [fnmatch.fnmatch(_kernel_name(name), p) for p in pats]
        return all(hits) if match == "all" else any(hits)

    return matches


def matched_spans(events, kernels=None, match: str = "any") -> list:
    """(start, end) of the CPU op events (``torch.profiler``'s
    ``FunctionEvent``s) whose names match any / all of the ``kernels``
    patterns, a nested match counted once (aten::matmul holds aten::mm)."""
    from torch.autograd import DeviceType

    matches = _matcher(kernels, match)

    def outermost(event) -> bool:
        parent = event.cpu_parent
        while parent is not None:
            if matches(parent.name):
                return False
            parent = parent.cpu_parent
        return True

    return [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CPU and matches(e.name) and outermost(e)]


def kernel_spans(trace_events, kernels=None, match: str = "any") -> list:
    """(start, end) in us of the device kernels (``"cat": "kernel"``) of a
    ``torch.profiler`` chrome trace whose names match the patterns."""
    matches = _matcher(kernels, match)
    return [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
            if e.get("cat") == "kernel" and "dur" in e and matches(e.get("name", ""))]


def _trace_events(prof) -> list:
    import json
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="mojo_prof_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def profiled_time_us(fn: Callable, *args, iters: int = 8, kernels=None, match: str = "any",
                     reduction: str = "span", device=None) -> float:
    """Time of one call attributed to profiler events, in microseconds:
    ``iters`` calls under ``torch.profiler``, the device kernels of its
    chrome trace on the card (CPU and CUDA activities; on CPU tensors the
    CPU op events) whose names match any (``match="any"``) or all
    (``"all"``) of the ``kernels`` patterns, reduced by ``"sum"`` (their
    time over ``iters``) or ``"span"`` (the first start to the last end,
    gaps included, over ``iters``). -1.0 when no event matched (on the card
    the kernels the trace did hold are then logged) or when the matches do
    not come in whole calls (a trace that lost records)."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device) if device is not None else device_of(args)
    on_card = device.type == "cuda"
    device_sync(fn(*args))
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        for _ in range(iters):
            out = fn(*args)
        device_sync(out)
    name = getattr(fn, "__name__", "fn")
    if on_card:
        events = _trace_events(prof)
        spans = kernel_spans(events, kernels, match)
        if not spans:
            names = sorted({e.get("name", "") for e in events if e.get("cat") == "kernel"})
            logger.info("%s: no kernel of the trace matches %s; its kernels: %s", name, list(kernels or ["*"]),
                        [n[:80] for n in names[:8]])
    else:
        spans = matched_spans(prof.events(), kernels, match)
    if len(spans) % iters:
        logger.info("%s: %d matching events over %d calls: the trace lost some, its time is not used", name,
                    len(spans), iters)
        return -1.0
    if not spans:
        return -1.0
    if reduction == "sum":
        total = sum(end - start for start, end in spans)
    else:
        total = max(end for _, end in spans) - min(start for start, _ in spans)
    return max(float(total) / iters, 1e-3)
