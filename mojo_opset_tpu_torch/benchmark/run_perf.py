"""Per-op benchmark runner CLI.

Counterpart of the JAX package's ``benchmark/run_perf.py`` (:38-201): build
each descriptor's op in the asked tier through dispatch, bind its state,
make one checked call, time it, and print a table.

Usage::

    python -m mojo_opset_tpu_torch.benchmark.run_perf --ops PagedDecodeGQA \
        --providers ref,cuda --preset smoke [--json out.json] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` asks for the CPU, where every
time is the host clock's (``"timing": "host"``). ``MOJO_LAUNCH_DEVICE``
pins the card (``benchmark/launch.py`` sets it for each worker). Each
record holds ``op``, ``case``, ``provider``, ``us``, ``timing`` (the timer:
``profiler`` where the spec names kernels and the profiler saw them, else
``graph``, ``events`` or ``host``), ``tflops`` and ``gbps`` where the
workload counts them, and on the ``cuda`` tier ``route``: ``golden`` where
a cuda-tier class's ``golden_calls`` moved during the checked call (a shape
its kernel does not take), else ``kernel``. The CLI logs a case that
raises and goes on, as JAX's does; ``run_sweep(..., strict=True)`` raises.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
from typing import Optional

import torch

from mojo_opset_tpu_torch.benchmark.api import DESCRIPTORS, PERF_REGISTRY, LiteralArg, PerfSpec, discover_perf_specs
from mojo_opset_tpu_torch.benchmark.timing import device_sync, profiled_time_us, timed_us
from mojo_opset_tpu_torch.core.registry import BackendNotAvailable
from mojo_opset_tpu_torch.utils.logging import get_logger, log_table
from mojo_opset_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)


def _on(value, device):
    return value.to(device) if isinstance(value, torch.Tensor) else value


def _build_op(impl, workload, device: torch.device):
    """The tier's op from the workload's op kwargs (their tensors on
    ``device``), built on ``device`` where the op takes one."""
    kwargs = {k: _on(v, device) for k, v in workload.op_kwargs.items()}
    if "device" in inspect.signature(impl.__init__).parameters:
        kwargs["device"] = device
    return impl(**kwargs).to(device)


def bind_state(op: torch.nn.Module, state: dict) -> None:
    """Put each ``{attribute: tensor}`` into the op's parameter or buffer of
    that name (dotted for a submodule's), dtype included; a shape that
    differs raises."""
    for name, value in state.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = op.get_submodule(owner_name)
        if leaf in owner._parameters:
            target = owner._parameters[leaf]
        elif leaf in owner._buffers:
            target = owner._buffers[leaf]
        else:
            raise AttributeError(f"{type(op).__name__} has no parameter or buffer {name!r}")
        if tuple(target.shape) != tuple(value.shape):
            raise ValueError(f"{type(op).__name__}.{name}: state {tuple(value.shape)} != {tuple(target.shape)}")
        target.data = value


def golden_count() -> int:
    """The sum of every cuda-tier class's ``golden_calls``."""
    from mojo_opset_tpu_torch.backends.cuda import kernels

    return sum(cls.golden_calls for cls in kernels.golden_classes())


class PreparedCase:
    """A case's op, inputs and call: ``call()`` runs it once; ``fn`` on
    ``args`` (``thread_idx`` feeding outputs back) is what the timers chain."""

    def __init__(self, spec: PerfSpec, op, workload, tensors: dict, device: torch.device):
        self.op, self.workload, self.tensors, self.device = op, workload, tensors, device

        def resolve(v):
            if isinstance(v, LiteralArg):
                return v.value
            if isinstance(v, str) and v in tensors:
                return tensors[v]
            return v

        self.args = tuple(resolve(a) for a in workload.args)
        self.kwargs = {k: resolve(v) for k, v in workload.kwargs.items()}
        run = workload.run or (lambda op_, *a, **kw: op_(*a, **kw))

        def fn(*args):
            with torch.no_grad():
                return run(op, *args, **self.kwargs)

        fn.__name__ = spec.name
        self.fn = fn
        self.thread_idx = tuple((workload.args.index(name), out_pos) for name, out_pos in workload.thread.items())

    def call(self):
        return device_sync(self.fn(*self.args))


def prepare_case(spec: PerfSpec, provider: str, case, device=None) -> Optional[PreparedCase]:
    """The case's op in tier ``provider`` with its state bound and inputs
    built on ``device`` (the card unless named); None where the tier is not
    registered for the op."""
    device = resolve_device(device)
    workload = spec.workload_fn(case)
    try:
        impl = spec.target.get_backend_impl(provider, strict=True)
    except BackendNotAvailable:
        return None
    op = _build_op(impl, workload, device)
    tensors = {name: ts.build(idx, device) for idx, (name, ts) in enumerate(workload.inputs.items())}
    bind_state(op, {attr: tensors[name] for attr, name in workload.state.items()})
    return PreparedCase(spec, op, workload, tensors, device)


def run_case(spec: PerfSpec, provider: str, case, iters: int = 16, validate_only: bool = False,
             device=None) -> Optional[dict]:
    """One record of the case in tier ``provider`` (None where the tier is
    not registered): one checked call, then its time."""
    prepared = prepare_case(spec, provider, case, device)
    if prepared is None:
        return None
    golden_before = golden_count()
    prepared.call()
    rec = {"op": spec.name, "case": case.id, "provider": provider}
    if provider == "cuda":
        rec["route"] = "golden" if golden_count() != golden_before else "kernel"
    if validate_only:
        return {**rec, "us": -1.0}

    prof = spec.profiling
    us, timing = -1.0, "profiler"
    if prof.kernels is not None:
        us = profiled_time_us(prepared.fn, *prepared.args, iters=iters, kernels=prof.kernels, match=prof.match,
                              reduction=prof.reduction, device=prepared.device)
    if us < 0:
        us, timing = timed_us(prepared.fn, *prepared.args, iters=iters, thread_idx=prepared.thread_idx,
                              device=prepared.device)
    # 3 decimals: the timer floors a marginal lost in noise at 1e-3 us
    rec.update(us=round(us, 3), timing=timing)
    workload = prepared.workload
    if workload.flops:
        rec["tflops"] = round(workload.flops / (us * 1e-6) / 1e12, 6)
    if workload.read_bytes or workload.write_bytes:
        total = (workload.read_bytes or 0) + (workload.write_bytes or 0)
        rec["gbps"] = round(total / (us * 1e-6) / 1e9, 6)
    return rec


def selected_cases(ops, preset: str):
    """(spec, case) of every registered spec in ``ops`` (None: all) that the preset keeps."""
    for name in ops or list(PERF_REGISTRY):
        spec = PERF_REGISTRY.get(name)
        if spec is None:
            logger.warning("unknown op %s (known: %s)", name, list(PERF_REGISTRY))
            continue
        for case in spec.cases:
            if preset == "smoke" and case.tags and "smoke" not in case.tags:
                continue
            yield spec, case


def run_sweep(ops=None, providers=("ref", "cuda"), preset: str = "smoke", iters: int = 16,
              validate_only: bool = False, device=None, strict: bool = False) -> list:
    """Records of every selected case and provider; a case that raises is
    logged and skipped, or with ``strict`` raises."""
    results = []
    for spec, case in selected_cases(ops, preset):
        for pname in providers:
            provider = next((p for p in spec.providers if p.name == pname), None)
            if provider is None or (provider.supports is not None and not provider.supports(case)):
                continue
            try:
                rec = run_case(spec, pname, case, iters=iters, validate_only=validate_only, device=device)
            except Exception as exc:
                if strict:
                    raise RuntimeError(f"{spec.name}/{case.id}/{pname} failed: {exc!r}") from exc
                logger.warning("%s/%s/%s failed: %r", spec.name, case.id, pname, exc)
                continue
            if rec is not None:
                results.append(rec)
                logger.info("%s", rec)
    return results


def log_results(results: list) -> None:
    log_table(logger, f"{'op':<28} | {'case':<24} | {'provider':<8} | {'us':>10} | {'timing':<8} | "
                      f"{'tflops':>10} | {'GB/s':>10} | route")
    log_table(logger, "-" * 124)
    for r in results:
        log_table(logger, f"{r['op']:<28} | {r['case']:<24} | {r['provider']:<8} | {r['us']:>10.3f} | "
                          f"{r.get('timing', ''):<8} | {r.get('tflops', ''):>10} | {r.get('gbps', ''):>10} | "
                          f"{r.get('route', '')}")


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ops", default=None, help="comma-separated op names (default all)")
    parser.add_argument("--providers", default="ref,cuda")
    parser.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    parser.add_argument("--iters", type=int, default=16)
    parser.add_argument("--json", default=None)
    parser.add_argument("--package", default=DESCRIPTORS)
    parser.add_argument("--validate", action="store_true",
                        help="build and run each case once (no timing): a workload check")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    pinned = os.environ.get("MOJO_LAUNCH_DEVICE")
    if pinned is not None:
        if device.type != "cuda":
            raise SystemExit(f"MOJO_LAUNCH_DEVICE={pinned} pins a card, but --device is {args.device}")
        device = torch.device("cuda", int(pinned))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run_perf runs on the card; pass --device cpu to run on the CPU")
    if pinned is not None:
        torch.cuda.set_device(device)
    discover_perf_specs(args.package)
    results = run_sweep(args.ops.split(",") if args.ops else None, args.providers.split(","), args.preset,
                        args.iters, args.validate, device)
    log_results(results)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
