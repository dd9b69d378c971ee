"""The program's spans in a traced slice (``perfbench/spans.py``), on synthetic profiler events: the harness's own
reduction unchanged beside them, the idle split that sums to the idle time, and the four readers."""

import gc
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import spans, trace
from perfbench.find import load_module

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
READERS = ("idle_ms.decode_launch", "idle_ms.decode_prepare", "idle_ms.decode_loop", "host_ms.decode_step")
WINDOWS = [{"id": 0, "span": "prefill", "call": 0, "from": 0, "to": 1, "lens": [5], "outs": [3]},
           {"id": 1, "span": "decode", "call": 0, "from": 1, "to": 3, "lens": [5], "outs": [3]}]

# times in microseconds. A prefill window (0-90), then a decode window (100-300) of two steps that opens and
# closes inside the hooks, as `perfbench/drivers/static_batch.py` marks it
HARNESS = [("perfbench.prefill.0", 0, 90), ("perfbench.decode.1", 100, 300)]
KERNELS = [("gemm_kernel", 10, 80), ("paged_decode_kernel", 140, 190), ("paged_decode_kernel", 240, 290),
           ("Memcpy HtoD (Pageable -> Device)", 295, 297)]
HOST = [("cudaLaunchKernel", 5, 9), ("cudaGraphLaunch", 132, 158), ("aten::copy_", 116, 118),
        ("cudaGraphLaunch", 228, 258)]
PROGRAM = [("mojo.prefill", 2, 85), ("mojo.session.prefill_inputs", 3, 8), ("mojo.hooks", 90, 105),
           ("mojo.decode_step", 110, 200), ("mojo.session.decode_arrays", 115, 125), ("mojo.graph.lookup", 126, 128),
           ("mojo.graph.replay", 130, 160), ("mojo.graph.inputs", 131, 135), ("mojo.graph.outputs", 150, 155),
           ("mojo.sample", 161, 165), ("mojo.hooks", 166, 170), ("mojo.host_sync", 171, 195),
           ("mojo.decode_step", 205, 310), ("mojo.session.decode_arrays", 210, 220), ("mojo.graph.replay", 225, 260),
           ("mojo.sample", 262, 266), ("mojo.hooks", 268, 305)]


def _event(name, a, b, device=CPU, annotation=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=float(a), end=float(b)), device_type=device,
                           is_user_annotation=annotation)


def _profile(with_program: bool, device_copies: bool = True):
    events = [_event(n, a, b) for n, a, b in HARNESS + HOST] + [_event(n, a, b, CUDA) for n, a, b in KERNELS]
    events += [_event(n, a + 1, b - 1, CUDA, True) for n, a, b in HARNESS]  # the harness's ranges, device side
    if with_program:
        events += [_event(n, a, b) for n, a, b in PROGRAM]
        if device_copies:
            events += [_event(n, a + 20, b, CUDA, True) for n, a, b in PROGRAM if n == "mojo.graph.replay"]
    return SimpleNamespace(events=lambda: list(events))


def _agg(profile):
    device, host, harness = trace._events(profile)
    device = [e for e in device if not e[0].startswith("mojo.")]
    host = [e for e in host if not e[0].startswith("mojo.")]
    return trace.reduce(device, host, harness, WINDOWS)


def _attached(profile):
    agg = _agg(profile)
    spans.attach(agg, SimpleNamespace(profile=profile, windows=WINDOWS))
    return agg


def test_program_ranges_and_their_device_copies_leave_the_harness_reduction_bit_equal():
    before = trace.reduce(*trace._events(_profile(False)), WINDOWS)
    assert _agg(_profile(True)) == before  # the program's ranges set apart, as ``spans.split`` does
    device, host = spans.split(*trace._events(_profile(True))[:2])
    assert len(device) == len(KERNELS) and len(host) == len(PROGRAM)
    # op ranges have no device-side copy: what the unchanged reduction reads of the device stays bit-equal, and
    # only the idle gaps' labels may name a program span
    plain = trace.reduce(*trace._events(_profile(True, device_copies=False)), WINDOWS)
    assert {k: v for k, v in plain.items() if k != "breakdown"} == {k: v for k, v in before.items() if k != "breakdown"}
    assert plain["breakdown"]["device_ops"] == before["breakdown"]["device_ops"]
    agg = _attached(_profile(True))
    assert agg["breakdown"]["device_ops"] == before["breakdown"]["device_ops"]
    assert agg["breakdown"]["idle_gaps"] == before["breakdown"]["idle_gaps"]


def test_idle_by_span_sums_to_the_idle_time_of_each_kind():
    agg = _attached(_profile(True))
    for kind in ("prefill", "decode"):
        part = agg[kind]
        assert abs(sum(part["idle_by_span"].values()) - (part["wall_s"] - part["busy_s"])) <= 1e-12
    decode = agg["decode"]["idle_by_span"]
    want = {"mojo.hooks": 13, "(none)": 10, "mojo.decode_step": 23, "mojo.session.decode_arrays": 20,
            "mojo.graph.lookup": 2, "mojo.graph.replay": 21, "mojo.graph.inputs": 4, "mojo.host_sync": 5}
    assert decode.keys() == want.keys() and all(abs(decode[k] - v * 1e-6) < 1e-12 for k, v in want.items())
    assert agg["breakdown"]["idle_spans"][0][0] == "mojo.decode_step"


def test_spans_are_clipped_to_the_windows_with_their_self_time():
    stats = _attached(_profile(True))["decode"]["spans"]
    assert (stats["mojo.decode_step"]["count"], stats["mojo.hooks"]["count"]) == (2, 3)
    assert abs(stats["mojo.decode_step"]["s"] - 185e-6) < 1e-12 and abs(stats["mojo.hooks"]["s"] - 41e-6) < 1e-12
    # self time: the steps' 185 us less their children's (the hooks inside the steps hold 36 us of their 41)
    children = sum(stats[n]["s"] for n in ("mojo.session.decode_arrays", "mojo.graph.lookup", "mojo.graph.replay",
                                           "mojo.sample", "mojo.host_sync")) + 36e-6
    assert abs(stats["mojo.decode_step"]["self_s"] - (185e-6 - children)) < 1e-12
    assert abs(stats["mojo.graph.replay"]["self_s"] - (65e-6 - 9e-6)) < 1e-12


@pytest.mark.parametrize("name, want", [("idle_ms.decode_launch", 13.5e-3), ("idle_ms.decode_prepare", 10e-3),
                                        ("idle_ms.decode_loop", 19e-3), ("host_ms.decode_step", 60e-3)])
def test_each_reader_per_decode_step(name, want):
    assert abs(load_module("metrics", name).read(_attached(_profile(True))) - want) < 1e-12


def test_the_idle_readers_and_the_hooks_make_up_the_decode_idle():
    agg = _attached(_profile(True))
    total = sum(load_module("metrics", name).read(agg) for name in READERS[:3])
    hooks = agg["decode"]["idle_by_span"]["mojo.hooks"] * 1e3 / 2
    idle = (agg["decode"]["wall_s"] - agg["decode"]["busy_s"]) * 1e3 / 2
    assert abs(total + hooks - idle) < 1e-12


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_the_programs_spans(name):
    agg = _attached(_profile(False))
    assert "spans" not in agg["decode"] and "idle_spans" not in agg["breakdown"]
    assert load_module("metrics", name).read(agg) is None
    partial = _attached(_profile(True))
    for part in ("decode", "prefill"):
        partial[part]["spans"] = {}
    assert load_module("metrics", name).read(partial) is None
    deviceless = _attached(_profile(True))  # a CPU run: no device operation, no idle to split
    deviceless["decode"]["busy_s"] = 0.0
    assert load_module("metrics", name).read(deviceless) is None


def test_attach_finds_the_one_slicer_whose_profile_is_held():
    gc.collect()  # slicers of earlier tests, if unreachable

    def slicer():
        made = trace.Slicer([{"span": "decode", "calls": [0, 1], "from": 1, "to": 3}], "cpu")
        made.profile, made.windows = _profile(True), WINDOWS
        return made

    def attached():
        agg = _agg(_profile(True))
        spans.attach(agg)
        return "idle_by_span" in agg["decode"]

    first = slicer()
    try:
        assert attached()
        second = slicer()
        assert not attached()  # two held: whose profile is unknown
        second.profile = None
        assert attached()
    finally:
        first.profile = None
    assert not attached()
