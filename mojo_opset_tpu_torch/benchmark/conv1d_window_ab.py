"""A/B of kernel Q's two window instantiations at one shape.

``csrc/conv1d.cu`` keeps the last W stream rows and the taps in registers,
in MAXW slots: a narrow instantiation (MAXW = 4) serves W <= 4, a wide one
(MAXW = 16) every W up to 16. This script compiles the file twice into a
private directory under ``_build/``: as it is, and with its W <= 4 branches
disabled, so the wide instantiation runs at the same W. Both builds get the
same inputs; their outputs must agree bit for bit (the wide build's extra
taps are zeros). The forward and the backward of each build are timed with
CUDA events, in the order narrow, wide, wide, narrow.

Run on a machine with a GPU and nvcc (the default shape is the conv
Function's training benchmark: B 8, T 8192, D 2048, W 4, SiLU, bf16 with an
fp32 weight and bias)::

    python -m mojo_opset_tpu_torch.benchmark.conv1d_window_ab [--B 8 --T 8192 --D 2048 --W 4 --iters 20]

It prints one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels.conv1d_vjp import MAX_SLOTS

NARROW_BRANCH = "if (W <= 4) {"
ENTRY_POINTS = ("mojo_conv1d_fwd", "mojo_conv1d_bwd")


def wide_source() -> str:
    """``conv1d.cu`` with both entry points' W <= 4 branches disabled."""
    text = (build.CSRC_DIR / "conv1d.cu").read_text()
    if text.count(NARROW_BRANCH) != 2:
        raise RuntimeError(f"expected the forward's and the backward's {NARROW_BRANCH!r} in conv1d.cu")
    return text.replace(NARROW_BRANCH, "if (false) {")


def _compile(sources: dict[str, str], out_dir: Path) -> dict[str, ctypes.CDLL]:
    nvcc = build.find_nvcc()
    procs = {}
    for tag, text in sources.items():
        src = out_dir / f"conv1d_{tag}.cu"
        src.write_text(text)
        lib = out_dir / f"libconv1d_{tag}.so"
        procs[tag] = (lib, subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-shared",
                                             "-o", str(lib), str(src)]))
    libs = {}
    for tag, (lib, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {tag} build of conv1d.cu")
        dll = ctypes.CDLL(str(lib))
        for name in ENTRY_POINTS:
            fn = getattr(dll, name)
            fn.argtypes = build.SIGNATURES[name]
            fn.restype = ctypes.c_int
        libs[tag] = dll
    return libs


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, default in (("B", 8), ("T", 8192), ("D", 2048), ("W", 4), ("iters", 20), ("seed", 0)):
        parser.add_argument(f"--{name}", type=int, default=default)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv1d_window_ab needs a CUDA device")
    B, T, D, W = args.B, args.T, args.D, args.W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(B, T, D, device=dev, generator=gen).bfloat16()
    g = torch.randn(B, T, D, device=dev, generator=gen).bfloat16()
    state = torch.randn(B, W - 1, D, device=dev, generator=gen).bfloat16()
    weight = torch.randn(D, W, device=dev, generator=gen) * 0.5
    bias = torch.randn(D, device=dev, generator=gen) * 0.1
    code = build.DTYPE_CODES[torch.bfloat16]
    vec = int(D % 8 == 0)
    stream = torch.cuda.current_stream().cuda_stream
    ins = (x.data_ptr(), state.data_ptr(), weight.data_ptr(), bias.data_ptr())

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        libs = _compile({"narrow": (build.CSRC_DIR / "conv1d.cu").read_text(), "wide": wide_source()}, Path(tmp))
        results = {}
        for tag, dll in libs.items():
            out, dx = torch.empty_like(x), torch.empty_like(x)
            part = torch.empty(MAX_SLOTS, W + 1, D, device=dev)
            dwb = torch.empty(W + 1, D, device=dev)

            def fwd(dll=dll, out=out):
                _check(dll.mojo_conv1d_fwd(*ins, out.data_ptr(), B, T, D, W, 1, vec, code, stream), "fwd")

            def bwd(dll=dll, dx=dx, part=part, dwb=dwb):
                _check(dll.mojo_conv1d_bwd(*ins, g.data_ptr(), dx.data_ptr(), part.data_ptr(), dwb.data_ptr(),
                                           B, T, D, W, 1, MAX_SLOTS, vec, code, stream), "bwd")

            fwd()
            bwd()
            results[tag] = dict(fwd=fwd, bwd=bwd, out=out, dx=dx, dwb=dwb, fwd_ms=[], bwd_ms=[])
        torch.cuda.synchronize()
        for name in ("out", "dx", "dwb"):
            if not torch.equal(results["narrow"][name], results["wide"][name]):
                raise SystemExit(f"the narrow and the wide builds disagree on {name}")
        for tag in ("narrow", "wide", "wide", "narrow"):
            for direction in ("fwd", "bwd"):
                results[tag][f"{direction}_ms"].append(_time_ms(results[tag][direction], args.iters))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    report = {"shape": dict(B=B, T=T, D=D, W=W, dtype="bfloat16", act="silu"), "card": smi[0] if smi else None,
              "bit_equal": True}
    for tag in ("narrow", "wide"):
        for direction in ("fwd", "bwd"):
            runs = results[tag][f"{direction}_ms"]
            report[f"{tag}_{direction}_ms"] = sum(runs) / len(runs)
            report[f"{tag}_{direction}_runs_ms"] = runs
    print(json.dumps(report))


if __name__ == "__main__":
    main()
