"""The traced run: torch.profiler over a slice of the window fixed by call
and position, reduced to aggregates that the per-layer metrics read.

A mix's ``trace`` is a list of parts, each ``{"span": <kind>, "calls":
[first, end), "from": a, "to": b}``: in each of those calls, the span of
that kind from position a to position b, where position 0 is the call's
start and position t >= 1 its t-th token on the host. So ``{"span":
"prefill", "from": 0, "to": 1}`` is a prefill (the call's start to its
first token) and ``{"span": "decode", "from": 1, "to": 33}`` 32 decode
steps. A new slice is data, and a new kind of span only a name. The
harness's own spans (``record_function``) mark each part; the profiler runs
from the first part's start to the last part's end, and only aggregates are
kept: per kind, its wall seconds, the seconds in which the device ran an
operation, each device operation's seconds by name, the kernels counted, and
each window's call, positions and request lengths for the work counts.
``breakdown`` lists the device operations that took most time and the idle
gaps by the host operation that was running.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "perfbench."
NOT_KERNELS = ("Memcpy", "Memset")
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without ``void``, anonymous namespaces, template arguments and parameters."""
    name = re.sub(r"^void ", "", name.strip()).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[:96] or "(unnamed)"


class Slicer:
    """Starts the profiler over the parts that ``spec`` lists, marks each
    window, and stops it; the stamping hook calls ``mark(call, position,
    lens, outs)`` at each position of a call and ``call_end(call)`` after it."""

    def __init__(self, spec: list, device):
        self.parts = [dict(p) for p in spec]
        for p in self.parts:
            c0, c1 = p["calls"]
            if not (isinstance(p["span"], str) and 0 <= c0 < c1 and 0 <= int(p["from"]) < int(p["to"])):
                raise ValueError(f"a trace part is span, calls [first, end), from < to: {p}")
        if not self.parts:
            raise ValueError("a trace names at least one part")
        self._left = sum(p["calls"][1] - p["calls"][0] for p in self.parts)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._activities = activities
        self._prof = None
        self._open: List[Tuple[dict, dict, object]] = []  # (part, window, record_function)
        self._count = 0
        self.profile = None  # the stopped profiler, for ``reduce``
        self.windows: List[dict] = []  # each closed window: span, call, from, to, lens, outs

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start is slow."""
        with torch.profiler.profile(activities=self._activities):
            torch.ones(1, device="cuda" if len(self._activities) > 1 else "cpu").add_(1).sum().item()

    def mark(self, call: int, position: int, lens, outs) -> None:
        """Position ``position`` of call ``call`` has come (0: its start; t: its t-th token on the host)."""
        for item in [o for o in self._open if o[1]["call"] == call and o[0]["to"] == position]:
            self._close(item, position)
        if self.profile is not None:
            return
        for part in self.parts:
            if part["calls"][0] <= call < part["calls"][1] and part["from"] == position:
                if self._prof is None:
                    self._prof = torch.profiler.profile(activities=self._activities)
                    self._prof.start()
                window = {"id": self._count, "span": part["span"], "call": call, "from": position,
                          "to": part["to"], "lens": [int(x) for x in lens], "outs": [int(x) for x in outs]}
                self._count += 1
                rf = torch.profiler.record_function(f"{SPAN}{part['span']}.{window['id']}")
                rf.__enter__()
                self._open.append((part, window, rf))

    def call_end(self, call: int, position: int) -> None:
        """Call ``call`` has ended at its ``position``-th token: its open windows end there."""
        for item in [o for o in self._open if o[1]["call"] == call]:
            self._close(item, position)

    def _close(self, item, position: int) -> None:
        part, window, rf = item
        rf.__exit__(None, None, None)
        self._open.remove(item)
        window["to"] = min(window["to"], position)
        self.windows.append(window)
        self._left -= 1
        if self._left == 0:
            self.stop()

    def stop(self) -> None:
        for item in list(self._open):  # the window closed inside a part: it is left out
            item[2].__exit__(None, None, None)
            self._open.remove(item)
        if self._prof is not None:
            self._prof.stop()
            self.profile, self._prof = self._prof, None


def _events(profile) -> Tuple[list, list, list]:
    """(device operations, host operations, the harness's spans) as
    (name, start_us, end_us) on the profiler's one clock."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in profile.events():
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN):
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name[len(SPAN):], start, end))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, start, end))
        else:
            host.append((e.name, start, end))
    return device, host, spans


def _clip(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """Union of ``intervals`` inside [lo, hi], merged and sorted."""
    cut = sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi)
    merged: List[List[float]] = []
    for a, b in cut:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _host_label(host_sorted: list, starts: list, t: float) -> str:
    """The innermost host operation running at ``t``: of those that cover it, the latest to start."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        name, a, b = host_sorted[j]
        if b >= t:
            return name
    return "(no host operation)"


def reduce(device_ops: list, host_ops: list, spans: list, windows: List[dict]) -> dict:
    """Aggregates of each kind of span and the ``breakdown``, from events as
    ``_events`` gives them (a span named ``<kind>.<window id>``) and the
    slicer's closed windows."""
    host_sorted = sorted(host_ops, key=lambda e: e[1])
    starts = [e[1] for e in host_sorted]
    by_id = {w["id"]: w for w in windows}
    out: dict = {}
    op_total: Dict[str, float] = defaultdict(float)
    gap_total: Dict[str, float] = defaultdict(float)
    busy_all = wall_all = 0.0
    for name, lo, hi in sorted(spans, key=lambda e: e[1]):
        kind, _, ident = name.rpartition(".")
        if not ident.isdigit() or int(ident) not in by_id:
            continue
        entry = out.setdefault(kind, {"wall_s": 0.0, "busy_s": 0.0, "ops": defaultdict(float), "kernels": 0,
                                      "windows": []})
        inside = [(n, a, b) for n, a, b in device_ops if lo <= a < hi]
        for n, a, b in inside:
            entry["ops"][short_name(n)] += (b - a) * 1e-6
            op_total[short_name(n)] += (b - a) * 1e-6
            entry["kernels"] += not n.startswith(NOT_KERNELS)
        merged = _clip([(a, b) for _, a, b in device_ops], lo, hi)
        busy = sum(b - a for a, b in merged)
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                gap_total[_host_label(host_sorted, starts, (a + b) / 2)] += (b - a) * 1e-6
        entry["wall_s"] += (hi - lo) * 1e-6
        entry["busy_s"] += busy * 1e-6
        entry["windows"].append({k: v for k, v in by_id[int(ident)].items() if k != "id"})
        busy_all += busy
        wall_all += hi - lo
    for entry in out.values():
        entry["ops"] = dict(entry["ops"])
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    out["busy_s"], out["window_s"] = busy_all * 1e-6, wall_all * 1e-6
    out["breakdown"] = {"device_ops": top(op_total), "idle_gaps": top(gap_total)}
    return out


def aggregates(slicer: Optional[Slicer]) -> Optional[dict]:
    if slicer is None or slicer.profile is None or not slicer.windows:
        return None
    device, host, spans = _events(slicer.profile)
    return reduce(device, host, spans, slicer.windows)
