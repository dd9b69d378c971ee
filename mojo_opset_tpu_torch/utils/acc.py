"""Accuracy comparison helpers on torch tensors.

Counterpart of the JAX package's ``utils/acc.py``:
  * default path: elementwise ``|a - b| <= atol + rtol * |b|`` in fp32;
  * ``ptol`` < 1.0: pass if the fraction of elementwise matches >= ptol;
  * ``mixed_tol``: magnitude-split 2^-6 — absolute tol where |ref| < 1,
    relative tol elsewhere.
Nested tuple/list results compare element by element with per-index
tolerances. ``DTYPE_TOLS`` is the BASELINE.md "Accuracy baselines" ladder.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _pick_nested_tol(value: Any, index: int):
    if isinstance(value, (tuple, list)):
        if len(value) <= index:
            raise IndexError(f"Tolerance tuple/list index {index} out of range for value {value}.")
        return value[index]
    return value


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(norm, ref, atol: float, rtol: float, msg: str = "") -> None:
    a = _as_f32(norm)
    b = _as_f32(ref)
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch: {a.shape} vs {b.shape}. {msg}")
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    bad = (diff > tol) & ~(np.isnan(a) & np.isnan(b))
    if bad.any():
        n_bad = int(bad.sum())
        max_abs = float(np.nanmax(diff))
        denom = np.maximum(np.abs(b), 1e-12)
        max_rel = float(np.nanmax(diff / denom))
        idx = np.unravel_index(int(np.argmax(np.where(bad, diff, -np.inf))), a.shape)
        raise AssertionError(
            f"Mismatch: {n_bad}/{a.size} elements exceed atol={atol} rtol={rtol}; "
            f"max_abs_diff={max_abs:.6g} max_rel_diff={max_rel:.6g} "
            f"worst at {idx}: got {a[idx]:.6g}, ref {b[idx]:.6g}. {msg}"
        )


def check_tol_diff(
    norm,
    ref,
    atol: float = 1e-2,
    rtol: float = 1e-2,
    ptol: float = 1.0,
    mixed_tol: bool = False,
):
    """Compare a computed result against a reference result.

    Args:
        norm: computed value (tensor/array or nested tuple/list of them).
        ref: reference value.
        atol / rtol: absolute / relative tolerance.
        ptol: percentage tolerance — pass when match_ratio >= ptol.
        mixed_tol: if true, atol/rtol/ptol are ignored; uses the 2^-6
            magnitude-split criterion instead.
    """
    if isinstance(norm, (tuple, list)):
        if not isinstance(ref, (tuple, list)) or len(norm) != len(ref):
            raise AssertionError(f"structure mismatch: {type(norm)}[{len(norm)}] vs {type(ref)}")
        for idx, (norm_i, ref_i) in enumerate(zip(norm, ref)):
            check_tol_diff(
                norm_i,
                ref_i,
                _pick_nested_tol(atol, idx),
                _pick_nested_tol(rtol, idx),
                _pick_nested_tol(ptol, idx),
                _pick_nested_tol(mixed_tol, idx),
            )
        return

    a = _as_f32(norm)
    b = _as_f32(ref)

    if mixed_tol:
        mask = np.abs(b) < 1.0
        tol = float(2**-6)
        assert_close(a[mask], b[mask], atol=tol, rtol=0.0, msg="(mixed_tol |ref|<1 branch)")
        assert_close(a[~mask], b[~mask], atol=0.0, rtol=tol, msg="(mixed_tol |ref|>=1 branch)")
    elif ptol != 1.0:
        if not ptol < 1.0:
            raise ValueError(f"{ptol=} should be <= 1.0")
        matches = np.isclose(a, b, rtol=rtol, atol=atol)
        total = matches.size
        match = int(matches.sum())
        mismatch = total - match
        match_ratio = match / max(total, 1)
        assert match_ratio >= ptol, (
            f"match_ratio={match_ratio:.5%} ({match=} / {mismatch=} / {total=}) "
            f"is under ptol={ptol:%}, please check!"
        )
    else:
        assert_close(a, b, atol=atol, rtol=rtol)


# dtype tolerance ladder (BASELINE.md "Accuracy baselines")
DTYPE_TOLS = {
    torch.bfloat16: dict(atol=0.1, rtol=0.05),
    torch.float16: dict(atol=2e-2, rtol=2e-2),
    torch.float32: dict(atol=6e-3, rtol=1e-4),
}


def tols_for(dtype: torch.dtype) -> dict:
    return dict(DTYPE_TOLS.get(dtype, dict(atol=1e-2, rtol=1e-2)))
