"""The port's per-op benchmark harness on the CPU: JAX's
tests/base/test_benchmark_api.py on ``mojo_opset_tpu_torch.benchmark``
(spec registration, workload checks, provider gating, ``run_case`` end to
end, the chain timer's state threading, profiler spans), the descriptors
held to JAX's tests/perf_new spec by spec, and the CLI's device rules.

Tolerances, and why: the descriptors' names, cases, shapes, dtypes, op
kwargs, args, kwargs, counts and threads are compared exactly, and so are
the integer inputs and the creators' outputs, bit for bit, with two
exceptions named where they are checked: GroupGemm's weight creator draws
normal samples from each framework's own generator (shape and dtype
compared), and GridRoPE's complex table is ``exp(i x)`` in two libraries
(within 2 fp32 ulps of 1). On the CPU every time is the host clock's.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mojo_opset_tpu_torch as m
from mojo_opset_tpu.benchmark import api as jax_api
from mojo_opset_tpu_torch.benchmark import run_perf
from mojo_opset_tpu_torch.benchmark.api import (
    PERF_REGISTRY,
    LiteralArg,
    PerfCase,
    PerfWorkload,
    discover_perf_specs,
    mojo_perf,
    perf_case,
    perf_provider,
    profile,
    tensor,
)
from mojo_opset_tpu_torch.benchmark.run_perf import run_case
from mojo_opset_tpu_torch.benchmark.timing import (
    device_time_us,
    kernel_spans,
    matched_spans,
    profiled_time_us,
    timed_us,
)

REPO = Path(__file__).resolve().parents[1]
JAX_SPECS = dict(jax_api.discover_perf_specs("tests.perf_new"))
PORT_SPECS = dict(discover_perf_specs())


@pytest.fixture(autouse=True)
def _registry_snapshot():
    before = dict(PERF_REGISTRY)
    yield
    PERF_REGISTRY.clear()
    PERF_REGISTRY.update(before)


def _register_rmsnorm_spec(**workload_extra):
    cases = [perf_case("tiny", tags=("smoke",), T=8, D=64), perf_case("big", tags=("full",), T=64, D=64)]

    @mojo_perf("UnitTestRMSNorm", m.MojoRMSNorm, cases)
    def wl(case):
        T, D = case.params["T"], case.params["D"]
        return PerfWorkload(
            inputs={"hidden": tensor((T, D), torch.float32), "weight": tensor((D,), torch.float32)},
            op_kwargs={"norm_size": D},
            state={"weight": "weight"},
            args=("hidden",),
            read_bytes=T * D * 4, write_bytes=T * D * 4,
            **workload_extra,
        )

    return PERF_REGISTRY["UnitTestRMSNorm"]


# -- JAX's tests/base/test_benchmark_api.py ------------------------------

def test_mojo_perf_registers_spec_with_cases_and_tags():
    spec = _register_rmsnorm_spec()
    assert spec.name == "UnitTestRMSNorm"
    assert [c.id for c in spec.cases] == ["tiny", "big"]
    assert "smoke" in spec.cases[0].tags
    assert spec.target is m.MojoRMSNorm
    assert [p.name for p in spec.providers] == ["ref", "cuda"]


def test_workload_validates_unknown_tensor_refs():
    with pytest.raises(ValueError):
        PerfWorkload(inputs={"x": tensor((4,), torch.float32)}, args=("x", "nonexistent"))


def test_workload_default_args_omit_state_and_kwarg_refs():
    wl = PerfWorkload(
        inputs={"x": tensor((4,), torch.float32), "w": tensor((4,), torch.float32), "m_": tensor((4,), torch.float32)},
        state={"weight": "w"},
        kwargs={"mask": "m_"},
    )
    assert wl.args == ("x",)


def test_tensor_spec_rejects_negative_shape():
    with pytest.raises(ValueError):
        tensor((-1, 4), torch.float32)


def test_provider_supports_predicate_gates_cases():
    cases = [perf_case("a", tags=("smoke",), big=False), perf_case("b", tags=("smoke",), big=True)]

    @mojo_perf("UnitTestGated", m.MojoRMSNorm, cases,
               providers=[perf_provider("ref", supports=lambda c: not c.params["big"])])
    def wl(case):
        return PerfWorkload(inputs={"hidden": tensor((4, 8), torch.float32)}, op_kwargs={"norm_size": 8},
                            args=("hidden",))

    spec = PERF_REGISTRY["UnitTestGated"]
    prov = spec.providers[0]
    assert prov.supports(spec.cases[0]) and not prov.supports(spec.cases[1])
    records = run_perf.run_sweep(["UnitTestGated"], ("ref",), iters=2, device="cpu")
    assert [r["case"] for r in records] == ["a"]


def test_run_case_end_to_end_on_cpu():
    spec = _register_rmsnorm_spec()
    rec = run_case(spec, "ref", spec.cases[0], iters=2, device="cpu")
    assert rec["op"] == "UnitTestRMSNorm"
    assert rec["us"] > 0
    assert rec["gbps"] > 0
    assert rec["timing"] == "host"
    cuda = run_case(spec, "cuda", spec.cases[0], iters=2, device="cpu")
    assert cuda["route"] == "kernel" and "route" not in rec


def test_run_case_returns_none_for_missing_provider():
    spec = _register_rmsnorm_spec()
    assert run_case(spec, "nonexistent_tier", spec.cases[0], device="cpu") is None
    # LayerNorm has no cuda tier
    assert run_case(PORT_SPECS["LayerNorm"], "cuda", PORT_SPECS["LayerNorm"].cases[0], device="cpu") is None


def test_device_time_us_monotone_in_work():
    # 4096x the work apart, and the best of 5 at each length: a host clock shared with other test workers
    # can stall one chain by milliseconds
    f = lambda a, b: a @ b  # noqa: E731
    t_small = device_time_us(f, torch.ones(64, 64), torch.ones(64, 64), iters=4, repeats=5, warmup=1)
    t_big = device_time_us(f, torch.ones(1024, 1024), torch.ones(1024, 1024), iters=4, repeats=5, warmup=1)
    assert t_big > t_small


@pytest.mark.parametrize("group_stops, calls", [(True, 1 + 2), (False, 1 + 2 + 2 + 4 + 4 + 8)])
def test_timing_chains_double_as_the_group_agrees(group_stops, calls):
    """``agree`` overrides this process's decision to stop doubling: a group
    that stops takes one pair of chains (1 and 2 calls, whatever their
    times), one that goes on doubles to ``max_iters``; each decision is
    asked once a pair."""
    asked, ran = [], []
    timed_us(lambda: ran.append(1), iters=1, repeats=1, warmup=0, max_iters=8,
             agree=lambda stop: asked.append(stop) or group_stops)
    assert len(ran) == calls and len(asked) == (1 if group_stops else 3)


def test_threaded_timing_chains_state():
    """thread_idx feeds outputs back as inputs: the chain iterates the
    state op, which writes the same tensor in place every call."""
    cache = torch.zeros(256, 256)
    seen = []

    def store(tok, cache):
        seen.append(cache)
        cache[0] += tok.sum()
        return (cache,)

    us, timer = timed_us(store, torch.ones(256), cache, iters=4, repeats=2, warmup=1, thread_idx=((1, 0),))
    assert us > 0 and timer == "host"
    assert all(c is cache for c in seen)  # never a copy
    assert float(cache[0, 0]) == 256.0 * len(seen)


def test_store_kv_descriptor_threads_caches():
    spec = PORT_SPECS["StorePagedKVCache"]
    wl = spec.workload_fn(spec.cases[0])
    assert wl.thread == {"key_cache": 0, "value_cache": 1}
    for name in wl.thread:  # positions resolve inside args
        assert name in wl.args


def test_store_kv_chain_writes_the_caches_in_place():
    prepared = run_perf.prepare_case(PORT_SPECS["StorePagedKVCache"], "ref", PORT_SPECS["StorePagedKVCache"].cases[1],
                                     device="cpu")
    key_cache = prepared.tensors["key_cache"]
    before = key_cache.clone()
    out = prepared.call()
    assert out[0] is key_cache and not torch.equal(key_cache, before)


def test_profile_spec_drives_profiler_span_timing():
    # profile(kernels=...) switches run_case to profiler timing; where no
    # event matches, the chain's timer stands and the record says which
    cases = [perf_case("tiny", tags=("smoke",), T=8, D=64)]

    @mojo_perf("UnitTestProfiled", m.MojoRMSNorm, cases, profiling=profile(kernels=("*",), reduction="sum"))
    def wl(case):
        T, D = case.params["T"], case.params["D"]
        return PerfWorkload(inputs={"hidden": tensor((T, D), torch.float32)}, op_kwargs={"norm_size": D},
                            args=("hidden",))

    rec = run_case(PERF_REGISTRY["UnitTestProfiled"], "ref", cases[0], iters=2, device="cpu")
    assert rec["us"] > 0 and rec["timing"] == "profiler"

    @mojo_perf("UnitTestUnmatched", m.MojoRMSNorm, cases, profiling=profile(kernels=("no_such_kernel_*",)))
    def wl2(case):
        return wl(case)

    rec = run_case(PERF_REGISTRY["UnitTestUnmatched"], "ref", cases[0], iters=2, device="cpu")
    assert rec["us"] > 0 and rec["timing"] == "host"


def test_profiled_time_us_matches_kernels_on_cpu():
    x = torch.ones(256, 256)
    f = lambda a: a @ a  # noqa: E731
    # the CPU op events stand for the kernels: aten::mm under aten::matmul
    us = profiled_time_us(f, x, iters=4, kernels=("aten::mm*",), reduction="sum")
    assert us > 0
    assert profiled_time_us(f, x, iters=2, kernels=("no_such_kernel_*",)) == -1.0


def test_profiled_time_refuses_a_trace_that_lost_records(monkeypatch):
    from mojo_opset_tpu_torch.benchmark import timing

    monkeypatch.setattr(timing, "matched_spans", lambda *a, **kw: [(0, 5), (6, 9), (10, 12)])
    assert profiled_time_us(lambda a: a + 1, torch.ones(4), iters=2, kernels=("*",)) == -1.0
    monkeypatch.setattr(timing, "matched_spans", lambda *a, **kw: [(0, 5), (6, 9)])
    assert profiled_time_us(lambda a: a + 1, torch.ones(4), iters=2, kernels=("*",), reduction="sum") == 4.0


def test_matched_spans_count_a_nested_match_once():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, start, end, parent=None):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                               device_type=DeviceType.CPU)

    matmul = event("aten::matmul", 0, 10)
    events = [matmul, event("aten::mm", 1, 9, matmul), event("aten::add", 11, 12)]
    assert matched_spans(events, ("aten::m*",)) == [(0, 10)]
    assert matched_spans(events, ("aten::mm",)) == [(1, 9)]
    assert matched_spans(events, ("aten::m*", "*mul"), match="all") == [(0, 10)]


def test_kernel_spans_read_the_trace_kernels():
    trace = [{"cat": "kernel", "name": "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128>(float*)",
              "ts": 2, "dur": 3},
             {"cat": "kernel", "name": "paged_decode_merge_kernel", "ts": 6, "dur": 1},
             {"cat": "cpu_op", "name": "paged_decode_gqa", "ts": 1, "dur": 9},
             {"cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4>()", "ts": 8, "dur": 1}]
    # a template kernel's demangled name starts with "void ", and the port's sit in an anonymous namespace
    assert kernel_spans(trace, ("paged_decode*",)) == [(2, 5), (6, 7)]
    assert kernel_spans(trace, ("*",)) == [(2, 5), (6, 7), (8, 9)]


# -- the port's own rules ---------------------------------------------------

def test_golden_route_is_recorded():
    """A cuda-tier call that takes the golden (QuantGemm at K % 16 != 0)
    says so in its record."""
    cases = [perf_case("k40", tags=("smoke",), M=8, K=40, N=32)]

    @mojo_perf("UnitTestQuantGemmGolden", m.MojoQuantGemm, cases)
    def wl(case):
        M, K, N = case.params["M"], case.params["K"], case.params["N"]
        return PerfWorkload(
            inputs={"input": tensor((M, K), torch.int8), "input_scale": tensor((M,), torch.float32),
                    "weight": tensor((K, N), torch.int8)},
            op_kwargs={"in_features": K, "out_features": N}, state={"weight": "weight"},
            args=("input", "input_scale"))

    rec = run_case(PERF_REGISTRY["UnitTestQuantGemmGolden"], "cuda", cases[0], iters=2, device="cpu")
    assert rec["route"] == "golden"


def test_bind_state_refuses_another_shape():
    op = m.MojoRMSNorm(norm_size=8, device="cpu")
    with pytest.raises(ValueError):
        run_perf.bind_state(op, {"weight": torch.ones(9)})
    with pytest.raises(AttributeError):
        run_perf.bind_state(op, {"no_such": torch.ones(8)})
    run_perf.bind_state(op, {"weight": torch.full((8,), 2.0, dtype=torch.bfloat16)})
    assert op.weight.dtype == torch.bfloat16 and float(op.weight[0]) == 2.0


def test_cli_defaults_to_the_card():
    """``run_perf`` runs on the card unless ``--device cpu``: without one
    it stops at once, and a pinned card with ``--device cpu`` is refused."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CLI on a machine without a card")
    with pytest.raises(SystemExit, match="--device cpu"):
        run_perf.main(["--ops", "RMSNorm"])
    os.environ["MOJO_LAUNCH_DEVICE"] = "0"
    try:
        with pytest.raises(SystemExit, match="pins a card"):
            run_perf.main(["--ops", "RMSNorm", "--device", "cpu"])
    finally:
        del os.environ["MOJO_LAUNCH_DEVICE"]


def test_cli_on_the_cpu_says_host(tmp_path):
    _register_rmsnorm_spec()
    out = tmp_path / "out.json"
    records = run_perf.main(["--ops", "UnitTestRMSNorm", "--providers", "ref,cuda", "--iters", "2", "--device", "cpu",
                             "--json", str(out)])
    assert [(r["case"], r["provider"]) for r in records] == [("tiny", "ref"), ("tiny", "cuda")]
    assert {r["timing"] for r in records} == {"host"}
    assert out.exists()


def test_strict_sweep_raises():
    cases = [perf_case("bad", tags=("smoke",), T=4, D=8)]

    @mojo_perf("UnitTestBroken", m.MojoRMSNorm, cases)
    def wl(case):
        return PerfWorkload(inputs={"hidden": tensor((4, 9), torch.float32)}, op_kwargs={"norm_size": 8},
                            args=("hidden",))

    assert run_perf.run_sweep(["UnitTestBroken"], ("ref",), device="cpu") == []
    with pytest.raises(RuntimeError, match="UnitTestBroken/bad/ref"):
        run_perf.run_sweep(["UnitTestBroken"], ("ref",), device="cpu", strict=True)


def test_import_loads_no_jax():
    code = ("import sys, mojo_opset_tpu_torch.benchmark.run_perf, mojo_opset_tpu_torch.benchmark.launch\n"
            "import mojo_opset_tpu_torch.benchmark.timing, mojo_opset_tpu_torch.benchmark.api\n"
            "from mojo_opset_tpu_torch.benchmark.api import discover_perf_specs\n"
            "assert len(discover_perf_specs()) == 52\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'mojo_opset_tpu'"
            " or m.startswith('mojo_opset_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=REPO,
                   timeout=120)


# -- the descriptors against JAX's ------------------------------------------

def test_descriptor_inventory():
    assert sorted(PORT_SPECS) == sorted(JAX_SPECS)
    assert len(PORT_SPECS) == 52
    cases = [c for s in PORT_SPECS.values() for c in s.cases]
    assert len(cases) == 115
    assert sum(1 for c in cases if not c.tags or "smoke" in c.tags) == 81


def test_jax_refuses_its_bare_string_kwarg():
    """JAX's two conv descriptors pass ``"silu"`` as a bare string, which
    its ``PerfWorkload`` takes for an input's name (ROADMAP.md queue 3,
    "JAX-side notes"); the port's pass a literal."""
    for name in ("CausalConv1dFunction", "CausalConv1dUpdateState"):
        with pytest.raises(ValueError, match="silu"):
            JAX_SPECS[name].workload_fn(JAX_SPECS[name].cases[0])
        port = PORT_SPECS[name].workload_fn(PORT_SPECS[name].cases[0])
        assert port.kwargs["activation"] == LiteralArg("silu")


def _lenient_post_init(self):
    """JAX's ``PerfWorkload.__post_init__`` without the reference check, so
    that its two conv workloads can be read."""
    if self.args is None:
        omitted = set(self.state.values()) | {v for v in self.kwargs.values() if isinstance(v, str)}
        object.__setattr__(self, "args", tuple(n for n in self.inputs if n not in omitted))


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) else str(jnp.dtype(dt))


def _np(value):
    """A tensor or array as numpy, bf16 as its bits."""
    if isinstance(value, torch.Tensor):
        return value.view(torch.int16).numpy() if value.dtype == torch.bfloat16 else value.numpy()
    arr = np.asarray(value)
    return arr.view(np.int16) if arr.dtype == jnp.bfloat16 else arr


def _same_value(got, want, inputs) -> bool:
    if isinstance(got, LiteralArg):
        if isinstance(want, str) and want not in inputs:  # JAX's bare string (see above)
            want = jax_api.LiteralArg(want)
        return isinstance(want, jax_api.LiteralArg) and _same_value(got.value, want.value, inputs)
    if isinstance(got, torch.dtype):
        return _dtype_name(got) == _dtype_name(want)
    if isinstance(got, torch.Tensor) or isinstance(want, np.ndarray) or hasattr(want, "dtype"):
        g, w = _np(got), _np(want)
        return g.shape == w.shape and _dtype_name(getattr(got, "dtype", g.dtype)) == _dtype_name(want.dtype) \
            and np.array_equal(g, w)
    return type(got) is type(want) and got == want


def _check_creator(name: str, inp: str, idx: int, ts, jts) -> None:
    if name == "GroupGemm" and inp == "weight":  # normal samples of each framework's own generator
        return
    got, w = ts.build(idx), np.asarray(jts.build(None, idx))
    if name == "GridRoPE":  # exp(i x) of two libraries
        np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=2 * np.finfo(np.float32).eps)
        return
    np.testing.assert_array_equal(_np(got), _np(w), err_msg=f"{name}.{inp}")


@pytest.mark.parametrize("name", sorted(JAX_SPECS))
def test_descriptor_matches_jax(name, monkeypatch):
    monkeypatch.setattr(jax_api.PerfWorkload, "__post_init__", _lenient_post_init)
    jspec, spec = JAX_SPECS[name], PORT_SPECS[name]
    assert spec.target.__name__ == jspec.target.__name__
    assert [(c.id, c.tags, dict(c.params)) for c in spec.cases] == \
        [(c.id, c.tags, dict(c.params)) for c in jspec.cases]
    assert (spec.profiling.kernels is None) == (jspec.profiling.kernels is None)
    assert (spec.profiling.match, spec.profiling.reduction) == (jspec.profiling.match, jspec.profiling.reduction)
    for case, jcase in zip(spec.cases, jspec.cases):
        got, want = spec.workload_fn(case), jspec.workload_fn(jcase)
        where = f"{name}/{case.id}"
        assert list(got.inputs) == list(want.inputs), where
        for idx, (inp, ts) in enumerate(got.inputs.items()):
            jts = want.inputs[inp]
            assert ts.shape == jts.shape and _dtype_name(ts.dtype) == _dtype_name(jts.dtype), (where, inp)
            assert (ts.creator is None) == (jts.creator is None), (where, inp)
            if ts.creator is not None:
                _check_creator(name, inp, idx, ts, jts)
            elif ts.dtype in (torch.int32, torch.int8):
                np.testing.assert_array_equal(ts.build(idx).numpy(), np.asarray(jts.build(None, idx)),
                                              err_msg=f"{where}.{inp}")
        assert set(got.op_kwargs) == set(want.op_kwargs), where
        for key, value in got.op_kwargs.items():
            assert _same_value(value, want.op_kwargs[key], want.inputs), (where, key)
        assert dict(got.state) == dict(want.state), where
        assert len(got.args) == len(want.args), where
        assert all(_same_value(a, b, want.inputs) for a, b in zip(got.args, want.args)), where
        assert set(got.kwargs) == set(want.kwargs), where
        assert all(_same_value(v, want.kwargs[k], want.inputs) for k, v in got.kwargs.items()), where
        assert (got.flops, got.read_bytes, got.write_bytes) == (want.flops, want.read_bytes, want.write_bytes), where
        assert dict(got.thread) == dict(want.thread), where
        assert (got.run is None) == (want.run is None), where
        assert dict(got.outputs) == {} == dict(want.outputs) and got.forward_args is want.forward_args is None


def _smallest_smoke(name: str) -> PerfCase:
    smoke = [c for c in PORT_SPECS[name].cases if "smoke" in c.tags]
    return min(smoke, key=lambda c: np.prod([v for v in c.params.values() if isinstance(v, int)]))


@pytest.mark.parametrize("name", ["RMSNorm", "ApplyRoPE", "PagedDecodeGQA"])
def test_descriptor_runs_on_ref(name):
    rec = run_case(PORT_SPECS[name], "ref", _smallest_smoke(name), iters=2, device="cpu")
    assert rec["us"] > 0 and rec["timing"] in ("host", "profiler")


@pytest.mark.parametrize("name", ["ApplyVisionRoPE2D", "QuantBatchGemmReduceSum", "CausalConv1dUpdateState",
                                  "CausalConv1dFunction"])
def test_repaired_descriptors_run(name):
    """The descriptors that needed a repair in the port: the vision RoPE op
    moves with ``.to()``, the reduce-sum GEMM takes JAX's (B, N) weight
    scale, the conv ops their literal activation and the conv Function a
    None final state under ``value_and_grad``."""
    case = PORT_SPECS[name].cases[0]
    if name == "CausalConv1dFunction":  # at a CPU size
        case = dataclasses.replace(case, params={**case.params, "B": 2, "T": 64, "D": 64})
    rec = run_case(PORT_SPECS[name], "ref", case, iters=1, validate_only=True, device="cpu")
    assert rec["us"] == -1.0
