"""Chrome-trace (chrome://tracing) JSON emitter, and the program's spans.

A copy of the JAX package's ``utils/tracing.py``: ``MojoTracingGenerator``
writes trace-event JSON (``M`` process and thread names, ``B``/``E``
spans, ``i`` instants, ``X`` complete events; ``span`` and ``save``) for
host-side timelines such as generator steps. Device timelines come from
``torch.profiler`` (``utils/profiler.py``).

``span(name, **args)`` is the one span primitive of the port's runtime
(``mojo.*``: the generate loop, the session, the graph pool). Tracing is on
while a ``torch.profiler`` runs or while a ``MojoTracingGenerator`` is
installed (``install`` / ``uninstall``). Off, a span reads two flags and is a
shared null context. On, it opens a profiler range, which lies on the same
clock as the device's kernels, and adds its ``B``/``E`` events, with
``args``, to the installed emitter. A span decides at entry whether it
records and exits whatever it entered, also when an exception passes
through. The range is a plain op range (``RecordScope.FUNCTION``), not a
user annotation: the profiler then gives it no device-side copy, so a
reader of the device's timeline sees only the operations that ran there.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# an op range: no device-side copy of the span (a ``record_function`` user annotation gets one on the card)
_RANGE = torch._C._profiler._RecordFunctionFast
_OFF = nullcontext()
_tracer: Optional["MojoTracingGenerator"] = None


class MojoTracingGenerator:
    def __init__(self, process_name: str = "mojo_opset_tpu_torch", pid: Optional[int] = None):
        self.pid = pid if pid is not None else os.getpid()
        self.events = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "args": {"name": process_name},
            }
        ]
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def set_thread_name(self, name: str, tid: Optional[int] = None):
        with self._lock:
            self.events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": self.pid,
                    "tid": tid if tid is not None else threading.get_ident(),
                    "args": {"name": name},
                }
            )

    def begin(self, name: str, tid: Optional[int] = None, **args):
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "ph": "B",
                    "pid": self.pid,
                    "tid": tid if tid is not None else threading.get_ident(),
                    "ts": self._now_us(),
                    "args": args,
                }
            )

    def end(self, name: str, tid: Optional[int] = None):
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "ph": "E",
                    "pid": self.pid,
                    "tid": tid if tid is not None else threading.get_ident(),
                    "ts": self._now_us(),
                }
            )

    def instant(self, name: str, tid: Optional[int] = None, **args):
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "ph": "i",
                    "s": "t",
                    "pid": self.pid,
                    "tid": tid if tid is not None else threading.get_ident(),
                    "ts": self._now_us(),
                    "args": args,
                }
            )

    def complete(self, name: str, start_us: float, dur_us: float, tid: Optional[int] = None, **args):
        with self._lock:
            self.events.append(
                {
                    "name": name,
                    "ph": "X",
                    "pid": self.pid,
                    "tid": tid if tid is not None else threading.get_ident(),
                    "ts": start_us,
                    "dur": dur_us,
                    "args": args,
                }
            )

    @contextmanager
    def span(self, name: str, **args):
        self.begin(name, **args)
        try:
            yield
        finally:
            self.end(name)

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)
        return path


def install(tracer: MojoTracingGenerator) -> None:
    """Send every span's ``B``/``E`` events to ``tracer`` until ``uninstall``."""
    global _tracer
    _tracer = tracer


def uninstall() -> None:
    global _tracer
    _tracer = None


class _Span:
    __slots__ = ("name", "args", "_range", "_tracer")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args

    def __enter__(self):
        self._tracer = _tracer
        self._range = _RANGE(self.name) if _autograd_profiler._is_profiler_enabled else None
        if self._range is not None:
            self._range.__enter__()
        if self._tracer is not None:
            self._tracer.begin(self.name, **self.args)
        return self

    def __exit__(self, *exc):
        if self._tracer is not None:
            self._tracer.end(self.name)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, **args):
    """A named span of the program (see the module's docstring); ``args`` go to the installed emitter only."""
    if _tracer is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)
