"""Kernel C's split count and kernel N's dx K ranges, swept at the smoke's shapes.

``paged_decode.split_count`` sizes kernel C's split-KV grid from shapes
alone, and ``flce.dx_splits`` picks how many K ranges kernel N's dx
product takes. This script calls the two C entry points with explicit
counts around each policy's choice, holds every result to the plain
version (the dtype's tolerance ladder), and times each from a CUDA graph
(20 calls replayed). Decode cases: Qwen3-4B's geometry (32/8 heads, D 128,
bf16, NHD pages of 64) at the smoke's main batch (contexts 1032, 545, 162,
39), at ctx 4000 with bs 1, 8 and 24, and at ctx 32768 with bs 4, with and
without local 1024 + global 64 windows; SDPA over the gathered pages is
timed beside the unwindowed ones. dx: the train step's lm_head (N 4096, H
2560, V 151936, bf16).

Run on a machine with a GPU and nvcc::

    python -m mojo_opset_tpu_torch.benchmark.split_sweep

It prints one JSON line.
"""

from __future__ import annotations

import json
import math
import subprocess

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import flce, paged_decode
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

H, HKV, D, PAGE = 32, 8, 128, 64
DECODE_CASES = (("main", [1032, 545, 162, 39], None, None), ("bs1_ctx4000", [4000], None, None),
                ("bs8_ctx4000", [4000] * 8, None, None), ("bs24_ctx4000", [4000] * 24, None, None),
                ("ctx32768", [32768] * 4, None, None), ("ctx32768_window", [32768] * 4, 1024, 64))


def graph_ms(fn, iters: int = 20) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def decode_case(lens, local, glob, gen) -> dict:
    dev = torch.device("cuda")
    cols = max(69, -(-max(lens) // PAGE))
    n_pages = max(4 * 69, sum(-(-n // PAGE) for n in lens))
    kc, vc = (torch.randn(n_pages, PAGE, HKV, D, device=dev, generator=gen).bfloat16() for _ in range(2))
    perm = torch.randperm(n_pages, device=dev, generator=gen).tolist()
    rows, used = [], 0
    for n in lens:
        need = -(-n // PAGE)
        rows.append(perm[used:used + need] + [-1] * (cols - need))
        used += need
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(len(lens), H, D, device=dev, generator=gen).bfloat16()
    want = paged_decode.paged_decode_gqa_plain(q, kc, vc, seq_lens, table, None, "AABB", "NHD",
                                               local_window=local, global_window=glob)
    lib = build.load_library()
    out = torch.empty_like(q)

    def run(splits, part):
        rc = lib.mojo_paged_decode(
            q.data_ptr(), kc.data_ptr(), vc.data_ptr(), None, None, seq_lens.data_ptr(), table.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), len(lens), H, HKV, D, PAGE, cols,
            *paged_decode.cache_strides(kc, "NHD"), splits, 1 / math.sqrt(D), 0, -1 if local is None else local,
            -1 if glob is None else glob, 0, build.DTYPE_CODES[torch.bfloat16],
            torch.cuda.current_stream().cuda_stream)  # the capture's stream inside graph_ms
        if rc != 0:
            raise RuntimeError(f"mojo_paged_decode failed: CUDA error {rc}")

    policy = paged_decode.split_count(len(lens), HKV, H // HKV, cols * PAGE, local, glob, build.sm_count(dev))
    result = {"policy": policy, "ms": {}}
    for splits in sorted({1, 2, 4, 8, 9, 16, 33, policy}):
        part = torch.empty(len(lens), H, splits, D + 2, device=dev) if splits > 1 else None
        run(splits, part)
        torch.cuda.synchronize()
        check_tol_diff(out, want, **tols_for(torch.bfloat16))
        result["ms"][splits] = graph_ms(lambda: run(splits, part))  # noqa: B023
    if local is None and glob is None:
        gather = table[:, :-(-max(lens) // PAGE)].clamp(min=0).long()
        k_dense, v_dense = (c[gather].reshape(len(lens), -1, HKV, D)[:, :max(lens)].transpose(1, 2).contiguous()
                            for c in (kc, vc))
        mask = (torch.arange(max(lens), device=dev) < seq_lens[:, None])[:, None, None]
        result["sdpa_ms"] = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k_dense, v_dense, attn_mask=mask, enable_gqa=True))
    return result


def dx_case(gen) -> dict:
    dev = torch.device("cuda")
    n, h, v = 4096, 2560, 151936
    dz = (torch.randn(n, v, device=dev, generator=gen) * 1e-3).bfloat16()
    w = (torch.randn(v, h, device=dev, generator=gen) * 0.02).bfloat16()
    want = flce.flce_dx_plain(dz, w)
    lib = build.load_library()
    out = torch.empty(n, h, dtype=torch.bfloat16, device=dev)

    def run(k, part):
        rc = lib.mojo_flce_dx(dz.data_ptr(), w.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
                              n, h, v, dz.stride(0), k, build.DTYPE_CODES[torch.bfloat16],
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mojo_flce_dx failed: CUDA error {rc}")

    result = {"policy": flce.dx_splits(n, h, v, build.sm_count(dev)), "ms": {}, "tflops": {}}
    for k in (1, 2, 4):
        part = torch.empty(k, n, h, device=dev) if k > 1 else None
        run(k, part)
        torch.cuda.synchronize()
        check_tol_diff(out, want, **tols_for(torch.bfloat16))
        result["ms"][k] = graph_ms(lambda: run(k, part), iters=5)  # noqa: B023
        result["tflops"][k] = 2 * n * h * v / result["ms"][k] / 1e9
    return result


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("split_sweep needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"decode": {name: decode_case(lens, local, glob, gen) for name, lens, local, glob in DECODE_CASES}}
    torch.cuda.empty_cache()
    report["flce_dx"] = dx_case(gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    report["card"] = smi[0] if smi else None
    print(json.dumps(report))


if __name__ == "__main__":
    main()
