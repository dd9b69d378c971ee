"""The flags every example shares, and the tooling they wire into a run.

  * ``--device`` (default ``cuda``): where the model and its session live;
    an example never lands on the CPU unless asked;
  * ``--debug-compare RULES`` / ``--debug-dump RULES``: the precision
    debugger (``utils/debugger.py``) with these rules for the run; the run
    goes eager, since a CUDA graph replays no Python (the debugger enabled
    otherwise, by ``MOJO_DEBUG=1`` or its API, leaves graphs on and skips
    their captures); dumps land in ``MojoDebugger.dump_dir``
    (``mojo_debug_dump/rank<N>/`` by default);
  * ``--profile-dir DIR``: a ``torch.profiler`` chrome trace of the run
    under ``DIR`` (``utils/profiler.py``);
  * ``--trace-out PATH``: the run's host-side spans as chrome-trace JSON
    (``utils/tracing.py``): the example's own and, with the emitter
    installed while the run lasts, the runtime's ``mojo.*`` spans.
"""

from __future__ import annotations

import contextlib
import os

import torch

from mojo_opset_tpu_torch.utils import tracing
from mojo_opset_tpu_torch.utils.debugger import MojoDebugger
from mojo_opset_tpu_torch.utils.profiler import profiler_activities
from mojo_opset_tpu_torch.utils.tracing import MojoTracingGenerator


def add_tool_flags(parser) -> None:
    parser.add_argument("--device", default="cuda", help="device of the model and its session (default: the card)")
    parser.add_argument("--debug-compare", default=None, metavar="RULES",
                        help="compare the ops these rules name with their golden tier, e.g. '0:*,31:*' "
                             "(runs eagerly)")
    parser.add_argument("--debug-dump", default=None, metavar="RULES",
                        help="dump the inputs and outputs of the ops these rules name (runs eagerly)")
    parser.add_argument("--profile-dir", default=None, help="write a torch.profiler chrome trace here")
    parser.add_argument("--trace-out", default=None, help="write the run's host spans as chrome-trace JSON")


def example_device(args) -> torch.device:
    """``--device``: the card unless the caller names another; without a
    GPU the default raises rather than landing on the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the examples run on the card by default; "
                           "pass --device cpu to run on the CPU")
    return device


def model_dtype(device) -> torch.dtype:
    """bf16 on the card, fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def debugging(args) -> bool:
    return bool(args.debug_compare or args.debug_dump)


@contextlib.contextmanager
def run_tools(args, result: dict, name: str, profile_whole_run: bool = True):
    """Enable what the flags ask for around the run and fill ``result``:
    ``tracer`` (a ``MojoTracingGenerator``, or None, installed as the
    runtime's span emitter) while it runs; after it, ``debug`` (the
    debugger's records and counts), ``trace`` and ``profile`` (the files
    written). ``profile_whole_run=False`` leaves
    the profiler to a generator hook."""
    tracer = MojoTracingGenerator(process_name=name) if args.trace_out else None
    result["tracer"] = tracer
    if debugging(args):
        MojoDebugger.enable(compare=args.debug_compare, dump=args.debug_dump)
    profile = None
    if args.profile_dir and profile_whole_run:
        profile = torch.profiler.profile(activities=profiler_activities(args.device))
        profile.__enter__()
    if tracer is not None:
        tracing.install(tracer)
    try:
        with tracer.span(name) if tracer else contextlib.nullcontext():
            yield tracer
    finally:
        if tracer is not None:
            tracing.uninstall()
        if profile is not None:
            if torch.device(args.device).type == "cuda":
                torch.cuda.synchronize()
            profile.__exit__(None, None, None)
            os.makedirs(args.profile_dir, exist_ok=True)
            result["profile"] = [os.path.join(args.profile_dir, "trace.json")]
            profile.export_chrome_trace(result["profile"][0])
        if debugging(args):
            MojoDebugger.disable()
            result["debug"] = {"records": list(MojoDebugger.records), "counts": dict(MojoDebugger.counts)}
        result.pop("tracer")
        if tracer is not None:
            result["trace"] = tracer.save(args.trace_out)


def report(result: dict) -> None:
    """Print the tooling's outcome lines."""
    if "debug" in result:
        counts = result["debug"]["counts"]
        print(f"debugger: {counts['compare']} compare records, {counts['dump']} dumps, {counts['errors']} errors")
    for path in result.get("profile", []):
        print(f"profiler trace: {path}")
    if "trace" in result:
        print(f"chrome trace: {result['trace']}")
