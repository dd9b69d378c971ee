"""Math helpers (counterpart of the JAX package's ``core/operators/misc.py``)."""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=8)
def _hadamard(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    h = torch.ones((1, 1), dtype=dtype, device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], dim=1), torch.cat([h, -h], dim=1)], dim=0)
    return h


def hadamard(n: int, dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Walsh-Hadamard matrix of size ``n`` (a power of two), Sylvester
    construction, entries +-1. One matrix is built per (n, dtype, device)
    and handed to every later call (8192 fp32 rows are 256 MiB): treat it
    as read-only."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"hadamard size must be a power of 2, got {n}")
    return _hadamard(n, dtype, torch.device(device if device is not None else "cpu"))
