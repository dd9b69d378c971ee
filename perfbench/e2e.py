"""The end-to-end metrics, from the host clock's stamps of one window.

A call is a dict: ``start`` (the host clock when it was made), ``stamps``
(when each of its steps' tokens reached the host, in order, only those
inside the window) and ``outs`` (each request's output length: request i
is served the call's first ``outs[i]`` tokens and is done then, though the
batch runs on to its longest). Every rate covers the whole window and every
tail every sample in it, request by request.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def p95(values) -> Optional[float]:
    values = np.asarray(values, np.float64)
    return float(np.percentile(values, 95)) if values.size else None


def served(call: dict) -> np.ndarray:
    """Tokens each request of ``call`` was served inside the window."""
    return np.minimum(np.asarray(call["outs"]), len(call["stamps"]))


def done(call: dict) -> np.ndarray:
    """Which requests of ``call`` got their last token inside the window."""
    return np.asarray(call["outs"]) <= len(call["stamps"])


def output_tok_s(calls: List[dict], t_open: float, t_close: float) -> Optional[float]:
    """Tokens served to requests inside the window over its length."""
    tokens = int(sum(served(c).sum() for c in calls))
    return tokens / (t_close - t_open) if tokens else None


def itl_p95_ms(calls: List[dict], t_open: float, t_close: float) -> Optional[float]:
    """95th percentile of every request's gaps between its consecutive tokens
    inside the window (the gap before token j + 1 counts once for each request
    still served then)."""
    gaps = []
    for c in calls:
        step_gaps = np.diff(np.asarray(c["stamps"], np.float64))
        wanting = (np.asarray(c["outs"])[None, :] >= np.arange(2, step_gaps.size + 2)[:, None]).sum(axis=1)
        gaps.append(np.repeat(step_gaps, wanting))
    value = p95(np.concatenate(gaps or [np.empty(0)]))
    return None if value is None else value * 1e3


def ttft_p95_ms(calls: List[dict], t_open: float, t_close: float) -> Optional[float]:
    """95th percentile over the requests done inside the window of the time
    from their call's start to its first token on the host."""
    ttfts = [c["stamps"][0] - c["start"] for c in calls if c["stamps"] for _ in range(int(done(c).sum()))]
    value = p95(ttfts)
    return None if value is None else value * 1e3


WINDOW_METRICS = {"output_tok_s": output_tok_s, "itl_p95_ms": itl_p95_ms, "ttft_p95_ms": ttft_p95_ms}


def end_to_end(names, calls: List[dict], t_open: float, t_close: float, setup_s: float) -> dict:
    """``{name: value}`` for the end-to-end metrics ``names``; a metric with
    no sample in the window is left out."""
    out = {}
    for name in names:
        value = setup_s if name == "setup_s" else WINDOW_METRICS[name](calls, t_open, t_close)
        if value is not None:
            out[name] = value
    return out
