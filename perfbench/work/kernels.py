"""Operations and bytes of the attention kernels, worked out from shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the work is what these lengths need:

* paged decode (one query row a sequence): the sequence's K and V at its
  length, its query and its output, in every layer;
* paged prefill (a whole prompt, no earlier context): QK and PV over the
  causal triangle; its q, k, v and output once. Its least time is the
  larger of operations over the peak rate and bytes over the bandwidth,
  taken per sequence and layer.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _elem(cfg: dict) -> int:
    return DTYPE_BYTES[cfg.get("torch_dtype", "bfloat16")]


def paged_decode_bytes(cfg: dict, contexts: Iterable[int]) -> float:
    """One decode step, every layer: K and V of each sequence at ``contexts``
    keys, plus q and out of each row."""
    c = np.asarray(list(contexts), np.float64)
    D, Hq, Hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    kv = 2.0 * Hkv * D * float(c.sum())
    rows = 2.0 * Hq * D * c.size
    return (kv + rows) * _elem(cfg) * cfg["num_hidden_layers"]


def paged_prefill_least_s(cfg: dict, lengths: Iterable[int], peak_ops: float, peak_bytes: float) -> float:
    """Least seconds of the prefill attention of prompts of ``lengths``, every layer."""
    s = np.asarray(list(lengths), np.float64)
    D, Hq, Hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ops = 2.0 * Hq * D * s * (s + 1)
    nbytes = s * (2 * Hq + 2 * Hkv) * D * _elem(cfg)
    return float(np.maximum(ops / peak_ops, nbytes / peak_bytes).sum()) * cfg["num_hidden_layers"]
