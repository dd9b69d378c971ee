"""Chrome-trace (chrome://tracing) JSON emitter.

A copy of the JAX package's ``utils/tracing.py``: ``MojoTracingGenerator``
writes trace-event JSON (``M`` process and thread names, ``B``/``E``
spans, ``i`` instants, ``X`` complete events; ``span`` and ``save``) for
host-side timelines such as generator steps. Device timelines come from
``torch.profiler`` (``utils/profiler.py``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Optional


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
