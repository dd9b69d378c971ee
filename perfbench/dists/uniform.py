"""Uniform lengths between ``min`` and ``max``."""

import numpy as np


def quantile(spec: dict, q: np.ndarray) -> np.ndarray:
    lo, hi = float(spec["min"]), float(spec["max"])
    return lo + (hi - lo) * q
