"""The runtime's spans (``utils.tracing.span``) on the CPU: off they enter
no profiler range, they change no token, they nest as the generate loop,
the session and the graph pool run, and the benchmark's slicer still closes
its windows beside them."""

from collections import Counter

import numpy as np
import pytest
import torch

from mojo_opset_tpu_torch.utils import tracing
from tests.test_torch_tracing import _tiny_generator

IDS, LENS = np.array([1, 2, 3, 4, 5, 6, 7], np.int32), np.array([3, 4], np.int32)
STEPS = 6  # a call's tokens: the prefill's and STEPS - 1 decode steps'


class _CountingRange:
    """Stands in for the profiler range a span opens, counting each entry."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("mojo.")]


def _generate(gen, fused=False):
    return gen.generate_from_ids(IDS, LENS, max_decode_steps=STEPS, ignore_eos=True, fused_decode=fused)


def test_off_enters_no_profiler_range(monkeypatch):
    monkeypatch.setattr(tracing, "_RANGE", _CountingRange)
    monkeypatch.setattr(_CountingRange, "entered", 0)
    gen = _tiny_generator(STEPS)
    assert tracing.span("mojo.a", step=1) is tracing.span("mojo.b")  # one shared null context
    _generate(gen)
    _generate(gen, fused=True)
    assert _CountingRange.entered == 0
    _profiled(lambda: _generate(gen))  # the stand-in is what a span opens once a profiler runs
    assert _CountingRange.entered > 0


@pytest.mark.parametrize("fused", [False, True], ids=["stepwise", "fused"])
def test_ids_are_the_same_traced_or_not(tmp_path, fused):
    gen = _tiny_generator(STEPS)
    plain = _generate(gen, fused)
    profiled, events = _profiled(lambda: _generate(gen, fused))
    tracer = tracing.MojoTracingGenerator()
    tracing.install(tracer)
    try:
        emitted = _generate(gen, fused)
    finally:
        tracing.uninstall()
    np.testing.assert_array_equal(profiled, plain)
    np.testing.assert_array_equal(emitted, plain)
    assert events and Counter(e["name"] for e in tracer.events if e["ph"] == "B") == Counter(
        e["name"] for e in tracer.events if e["ph"] == "E")
    begin = next(e for e in tracer.events if e["name"] == "mojo.generate")
    assert begin["args"] == {"call": 3, "batch": 2, "prompt_tokens": 7}


def test_spans_name_count_and_nest_each_decode_step():
    gen = _tiny_generator(STEPS)
    _, events = _profiled(lambda: _generate(gen))
    counts = Counter(e.name for e in events)
    n = STEPS - 1
    assert (counts["mojo.generate"], counts["mojo.prefill"], counts["mojo.decode_step"],
            counts["mojo.session.decode_arrays"], counts["mojo.host_sync"]) == (1, 1, n, n, n + 1)
    assert counts["mojo.session.prefill_inputs"] == 1 and counts["mojo.sample"] == n + 1
    assert {e.cpu_parent.name for e in events if e.name == "mojo.session.decode_arrays"} == {"mojo.decode_step"}
    assert {e.cpu_parent.name for e in events if e.name == "mojo.session.prefill_inputs"} == {"mojo.prefill"}
    assert {e.cpu_parent.name for e in events if e.name == "mojo.decode_step"} == {"mojo.generate"}
    steps = sorted((e for e in events if e.name == "mojo.decode_step"), key=lambda e: e.time_range.start)
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(steps, steps[1:]))


def test_the_benchmark_slicer_closes_its_windows_beside_the_spans():
    from perfbench import trace
    from mojo_opset_tpu_torch.runtime.generation import GeneratorHook

    slicer = trace.Slicer([{"span": "prefill", "calls": [0, 1], "from": 0, "to": 1},
                           {"span": "decode", "calls": [0, 1], "from": 1, "to": 4}], "cpu")

    class Marks(GeneratorHook):  # the positions as perfbench/drivers/static_batch.py marks them
        def before_prefill(self, **kwargs):
            slicer.mark(0, 0, LENS, [STEPS, STEPS])

        def before_decode(self):
            slicer.mark(0, 1, LENS, [STEPS, STEPS])

        def after_decode_step(self, *, step, logits, next_token_id):
            if step > 1:
                slicer.mark(0, step, LENS, [STEPS, STEPS])

        def after_decode(self, **kwargs):
            slicer.call_end(0, STEPS)

    gen = _tiny_generator(STEPS)
    want = _generate(gen)
    gen._hooks.append(Marks())
    np.testing.assert_array_equal(_generate(gen), want)
    assert slicer.profile is not None and [(w["span"], w["from"], w["to"]) for w in slicer.windows] == [
        ("prefill", 0, 1), ("decode", 1, 4)]
    _, host, spans = trace._events(slicer.profile)
    program = {name: sorted((a, b) for n, a, b in host if n == name) for name in ("mojo.hooks", "mojo.decode_step")}
    (_, p0, p1), (_, d0, d1) = sorted(spans, key=lambda s: s[1])
    assert p0 < p1 <= d0 < d1
    # the profiler starts at the first mark, inside hooks entered untraced; every later mark lies inside a traced
    # run of the hooks. The decode window holds steps 1-3 whole and closes in step 4's hooks, where the profiler
    # stops: the ranges still open there end with it
    assert all(p0 < a for a, _ in program["mojo.hooks"])
    for t in (p1, d0, d1):
        assert any(a <= t <= b for a, b in program["mojo.hooks"])
    assert [d0 < a < b < d1 for a, b in program["mojo.decode_step"]] == [True, True, True, False]
    assert program["mojo.decode_step"][-1][1] == program["mojo.hooks"][-1][1] == d1
