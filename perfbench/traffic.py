"""The one traffic generator: requests from a mix file's parameters and the seed.

A mix names two length distributions, ``prompt_len`` and ``output_len``,
each ``{"dist": <name>, ...its parameters, "min", "max"}``: the quantile
function of ``perfbench/dists/<name>.py``, rounded and clipped to
[``min``, ``max``]. Each is taken as a fixed set, its ``batch`` stratified
quantiles, and every call holds both whole sets, paired in an order drawn
from the seed (one permutation for prompts, another for outputs). So every
seed gets the same sizes in another order and pairing. Token ids are
uniform over the vocabulary, drawn from the seed for each call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from perfbench.find import load_module


def stratified_lengths(spec: dict, n: int, root: Optional[Path] = None) -> np.ndarray:
    """The ``n`` quantiles at (i + 0.5) / n of ``spec``'s distribution, rounded, clipped, ascending."""
    lo, hi = float(spec.get("min", 1)), float(spec.get("max", np.inf))
    if not 1 <= lo <= hi:
        raise ValueError(f"lengths need 1 <= min <= max: {spec}")
    q = (np.arange(n) + 0.5) / n
    values = np.asarray(load_module("dists", spec["dist"], root).quantile(spec, q), np.float64)
    return np.sort(np.clip(np.rint(values), lo, hi).astype(np.int64))


def longest_sequence(mix: dict, root: Optional[Path] = None) -> int:
    """The longest prompt and the longest output of the mix, together: what a slot has to hold."""
    n = int(mix["batch"])
    return int(stratified_lengths(mix["prompt_len"], n, root).max() + stratified_lengths(mix["output_len"], n, root).max())


class Traffic:
    """Call ``k``'s prompts and output lengths for a mix, a vocabulary and a seed."""

    def __init__(self, mix: dict, vocab_size: int, seed: int, root: Optional[Path] = None):
        self.batch = int(mix["batch"])
        self.lengths = stratified_lengths(mix["prompt_len"], self.batch, root)
        self.outputs = stratified_lengths(mix["output_len"], self.batch, root)
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        if self.seed < 0:
            raise ValueError(f"the seed is a whole number >= 0, got {seed}")

    @property
    def longest_output(self) -> int:
        return int(self.outputs.max())

    def _rng(self, stream: int, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream, index])

    def _ids(self, lens: np.ndarray, stream: int, index: int) -> np.ndarray:
        return self._rng(stream, index).integers(0, self.vocab_size, int(lens.sum()), dtype=np.int64).astype(np.int32)

    def call(self, k: int):
        """(packed token ids (sum of lens,), lens (batch,), outputs (batch,)) of call ``k``: its prompt
        lengths and its output lengths, each the mix's set in an order of its own."""
        lens = self.lengths[self._rng(1, k).permutation(self.batch)].astype(np.int32)
        outs = self.outputs[self._rng(4, k).permutation(self.batch)].astype(np.int32)
        return self._ids(lens, 2, k), lens, outs

    def warmup(self):
        """(ids, lens) of a call of the mix's batch, with ids of its own, that meets every prompt length of its set."""
        lens = self.lengths[::-1].astype(np.int32)
        return self._ids(lens, 3, 0), lens
