"""The traffic generator: the same for a seed, another order and pairing of the same sizes for another seed,
and a length distribution found by name, also one that exists only in another root."""

import json
import time

import numpy as np
import pytest

from perfbench import harness
from perfbench.tests.helpers import ROOT, write_tiny_root
from perfbench.traffic import Traffic, longest_sequence, stratified_lengths

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


def _mix(name):
    return json.loads((ROOT / "perfbench" / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    a, b = Traffic(_mix(name), 151936, 2**31 + 3), Traffic(_mix(name), 151936, 2**31 + 3)
    for k in range(3):
        for x, y in zip(a.call(k), b.call(k)):
            assert np.array_equal(x, y)
    for x, y in zip(a.warmup(), b.warmup()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_differ_in_order_and_ids_not_in_sizes(name):
    mix = _mix(name)
    streams = [Traffic(mix, 151936, s) for s in SEEDS]
    calls = 2
    firsts = [np.concatenate([t.call(k)[0] for k in range(2)]) for t in streams]
    assert len({f[:64].tobytes() for f in firsts}) == len(SEEDS)
    for part in (1, 2):  # prompt lengths, output lengths: every call holds the same set for every seed
        sizes = [np.sort(t.call(k)[part]) for t in streams for k in range(calls)]
        assert all(np.array_equal(sizes[0], s) for s in sizes[1:])
        orders = {np.concatenate([t.call(k)[part] for k in range(calls)]).tobytes() for t in streams}
        assert len(orders) > 1
    pairs = {tuple(zip(*[t.call(0)[part].tolist() for part in (1, 2)])) for t in streams}
    assert len(pairs) > 1  # prompts and outputs are paired anew
    for t in streams:
        ids, lens, outs = t.call(0)
        assert ids.size == lens.sum() and ids.min() >= 0 and ids.max() < 151936
        assert lens.max() + outs.max() <= longest_sequence(mix) and outs.min() >= 1


def test_stratified_lengths():
    assert stratified_lengths({"dist": "uniform", "min": 10, "max": 20}, 5).tolist() == [11, 13, 15, 17, 19]
    z = 0.6744897501960817  # the standard normal at 0.75
    lognormal = stratified_lengths({"dist": "lognormal", "median": 100, "sigma": 0.5}, 2)
    assert lognormal.tolist() == [round(100 * np.exp(-0.5 * z)), round(100 * np.exp(0.5 * z))]
    clipped = stratified_lengths({"dist": "lognormal", "median": 100, "sigma": 3.0, "min": 20, "max": 300}, 2)
    assert clipped.tolist() == [20, 300]
    with pytest.raises(FileNotFoundError):
        stratified_lengths({"dist": "zipf", "min": 1, "max": 2}, 3)


def test_published_medians_and_means_of_the_conversation_mixes():
    """Azure's conversation trace as published: median prompt 1020, median output 129; the means near 1155 and 211."""
    for name in MIXES:
        mix = _mix(name)
        n = 1024
        prompts, outs = stratified_lengths(mix["prompt_len"], n), stratified_lengths(mix["output_len"], n)
        assert np.median(prompts) == pytest.approx(1020, rel=0.01) and np.median(outs) == pytest.approx(129, rel=0.02)
        assert prompts.mean() == pytest.approx(1155, rel=0.03) and outs.mean() == pytest.approx(211, rel=0.05)


def test_negative_seed_is_refused():
    with pytest.raises(ValueError):
        Traffic(_mix(MIXES[0]), 100, -1)


@pytest.mark.parametrize("name", MIXES)
def test_warmup_meets_every_length(name):
    mix = _mix(name)
    t = Traffic(mix, 1000, 1)
    ids, lens = t.warmup()
    assert lens.size == mix["batch"] and ids.size == lens.sum()
    assert np.array_equal(np.sort(lens), t.lengths)


DIST = '''"""Every length the same: the spec's ``value``."""

import numpy as np


def quantile(spec, q):
    return np.full(len(q), float(spec["value"]))
'''


def test_a_distribution_that_exists_only_in_another_root(tmp_path):
    """A new length distribution is a new file: a run whose mix names one that exists only in a temporary root."""
    root = write_tiny_root(tmp_path, dist="constant")
    mix_path = root / "perfbench" / "traffic" / "tiny-mix.json"
    mix = json.loads(mix_path.read_text())
    mix["prompt_len"] = {"dist": "constant", "value": 7}
    mix_path.write_text(json.dumps(mix))
    (root / "perfbench" / "dists").mkdir()
    (root / "perfbench" / "dists" / "constant.py").write_text(DIST)
    assert not (ROOT / "perfbench" / "dists" / "constant.py").exists()
    assert Traffic(mix, 256, 3, root).call(0)[1].tolist() == [7, 7, 7]
    result = harness.run_cell(root, "tiny.cell", 2**31 + 5, 1.0, False, "cpu", time.perf_counter(),
                              log=lambda s: None)
    assert result["correct"] and result["attempted"] > 0
