"""Lognormal lengths: ``median`` x exp(``sigma`` x z) at the standard normal's quantile z (a heavy right tail)."""

from statistics import NormalDist

import numpy as np


def quantile(spec: dict, q: np.ndarray) -> np.ndarray:
    z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
    return float(spec["median"]) * np.exp(float(spec["sigma"]) * z)
