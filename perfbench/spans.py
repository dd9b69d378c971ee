"""The program's own spans in the traced slice, read beside ``trace.py``'s aggregates.

The program names its layers' spans ``mojo.*`` (the generate loop, the
session, the graph pool). Under the slicer's profiler each is a host range
on the same clock as the device's operations. For each kind of span of the
slice this adds to its aggregates:

* ``spans``: ``{name: {"count", "s", "self_s"}}``, each program span
  clipped to the kind's windows: how many overlap them, their seconds, and
  the seconds in which the span is the innermost one;
* ``idle_by_span``: ``{name or "(none)": seconds}``, the device's idle time
  in the windows split by overlap with the innermost program span over each
  part of it. The idle time is the complement of the same merged device
  intervals that give ``busy_s``, so the values sum to ``wall_s - busy_s``;

and to the ``breakdown``, ``idle_spans``: the top ``trace.TOP`` of
``idle_by_span`` over the slice, beside ``device_ops`` and ``idle_gaps``.

The per-layer metrics that read them call ``attach(agg)`` first. It finds the
run's stopped profile where the harness keeps it while the per-layer metrics
are read (the slicer's ``profile``), classifies its events as ``_events``
does, and sets the program's ranges apart: any device-side copy of a
``mojo.*`` range is dropped, as ``_events`` drops the harness's own. A run of
a program without such spans adds nothing, and its readers return None.
"""

from __future__ import annotations

import gc
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from perfbench import trace
from perfbench.work.model import decode_steps

PROGRAM = "mojo."
NONE = "(none)"
_DONE = "_program_spans"  # set in the aggregates once ``attach`` has run


def split(device_ops: list, host_ops: list) -> Tuple[list, list]:
    """(device operations, the program's host ranges) from ``trace._events``' device and host lists."""
    device = [e for e in device_ops if not e[0].startswith(PROGRAM)]
    program = [e for e in host_ops if e[0].startswith(PROGRAM)]
    return device, program


def _innermost(program: list, lo: float, hi: float) -> List[Tuple[float, float, str]]:
    """[lo, hi] in pieces ``(a, b, name)``: in each, the innermost program span over it (of those that cover it,
    the latest to start, the shortest on a tie), or NONE."""
    cut = [(max(a, lo), min(b, hi), a, -b, name) for name, a, b in program if b > lo and a < hi]
    points = sorted({lo, hi} | {x for c in cut for x in c[:2]})
    pieces = []
    for a, b in zip(points, points[1:]):
        over = [c for c in cut if c[0] <= a and b <= c[1]]
        pieces.append((a, b, max(over, key=lambda c: (c[2], c[3]))[4] if over else NONE))
    return pieces


def _idle(merged: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The gaps of ``merged`` (sorted, disjoint, inside [lo, hi]) in [lo, hi], as ``trace.reduce`` takes them."""
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def reduce_spans(device_ops: list, program: list, spans: list, windows: List[dict]) -> dict:
    """``{kind: {"spans", "idle_by_span"}}`` and ``"idle_spans"``, from the device operations and the program's
    ranges (both as ``split`` gives them), the harness's spans (``<kind>.<window id>``) and the closed windows."""
    by_id = {w["id"] for w in windows}
    out: Dict[str, dict] = {}
    idle_total: Dict[str, float] = defaultdict(float)
    intervals = [(a, b) for _, a, b in device_ops]
    for name, lo, hi in sorted(spans, key=lambda e: e[1]):
        kind, _, ident = name.rpartition(".")
        if not ident.isdigit() or int(ident) not in by_id:
            continue
        entry = out.setdefault(kind, {"spans": {}, "idle_by_span": defaultdict(float)})
        pieces = _innermost(program, lo, hi)
        for label, a, b in program:
            if b > lo and a < hi:
                stats = entry["spans"].setdefault(label, {"count": 0, "s": 0.0, "self_s": 0.0})
                stats["count"] += 1
                stats["s"] += (min(b, hi) - max(a, lo)) * 1e-6
        for a, b, label in pieces:
            if label != NONE:
                entry["spans"][label]["self_s"] += (b - a) * 1e-6
        i = 0
        for a, b in _idle(trace._clip(intervals, lo, hi), lo, hi):
            while pieces[i][1] <= a:
                i += 1
            j = i
            while j < len(pieces) and pieces[j][0] < b:
                x, y, label = pieces[j]
                part = (min(b, y) - max(a, x)) * 1e-6
                entry["idle_by_span"][label] += part
                idle_total[label] += part
                j += 1
    for entry in out.values():
        entry["idle_by_span"] = dict(entry["idle_by_span"])
    ranked = sorted(idle_total.items(), key=lambda kv: -kv[1])[:trace.TOP]
    return {"kinds": out, "idle_spans": [[k, v] for k, v in ranked]}


def _slicer() -> Optional[trace.Slicer]:
    """The run's slicer: the one slicer whose stopped profile is still held (none where two are: whose is unknown)."""
    held = [o for o in gc.get_objects() if type(o) is trace.Slicer and o.profile is not None]
    return held[0] if len(held) == 1 else None


def attach(agg: dict, slicer: Optional[trace.Slicer] = None) -> None:
    """Add ``spans`` and ``idle_by_span`` to each kind of ``agg``, and ``idle_spans`` to its breakdown, once; where
    the slice holds no program span, add nothing."""
    if agg.get(_DONE):
        return
    agg[_DONE] = True
    slicer = slicer or _slicer()
    if slicer is None:
        return
    device, host, spans = trace._events(slicer.profile)
    device, program = split(device, host)
    if not program:
        return
    extra = reduce_spans(device, program, spans, slicer.windows)
    for kind, entry in extra["kinds"].items():  # the kinds of ``trace.reduce``: the same spans and windows
        agg[kind].update(entry)
    agg["breakdown"]["idle_spans"] = extra["idle_spans"]


def decode(agg: dict, needs: str):
    """``(agg["decode"], its decode steps)`` with the program's spans attached, or None where the traced decode
    steps ran no operation on a device (a CPU run: no idle to split) or hold no span named ``needs``."""
    part = agg.get("decode")
    if not part or part["busy_s"] <= 0 or not decode_steps(part):
        return None
    attach(agg)
    if needs not in part.get("spans", {}):
        return None
    return part, decode_steps(part)


def idle_ms(agg: dict, needs: str, under) -> Optional[float]:
    """Device idle a traced decode step, in ms, under the innermost spans for which ``under(name)`` holds."""
    found = decode(agg, needs)
    if found is None:
        return None
    part, steps = found
    return 1e3 * sum(s for name, s in part["idle_by_span"].items() if under(name)) / steps
