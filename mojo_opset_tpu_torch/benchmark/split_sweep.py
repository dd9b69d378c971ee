"""Kernel C's split count, kernel N's dx K ranges, kernel F's and G's routes and kernel L's launch shape, swept at
the smoke's shapes.

``paged_decode.split_count`` sizes kernel C's split-KV grid from shapes
alone, ``flce.dx_splits`` picks how many K ranges kernel N's dx product
takes, and ``int8_matmul.route`` picks kernel F's wgmma tile width at
prefill and its K splits at decode. This script calls the C entry points
with explicit counts around each policy's choice, holds every result to
the plain version (the dtype's tolerance ladder; F exactly, at unit scales
with fp32 output), and times each from a CUDA graph (20 calls replayed).
Decode cases: Qwen3-4B's geometry (32/8 heads, D 128, bf16, NHD pages of
64) at the smoke's main batch (contexts 1032, 545, 162, 39), at ctx 4000
with bs 1, 8 and 24, and at ctx 32768 with bs 4, with and without local
1024 + global 64 windows; SDPA over the gathered pages is
timed beside the unwindowed ones. dx: the train step's lm_head (N 4096, H
2560, V 151936, bf16). F: the w8a8 projections of Qwen3-4B and
Seed-OSS-36B at prefill (M 1650, tile width 128 and 256) and at decode (M
8, and the lm_head at M 4: split counts 1 to 20), bf16 output. ``int4``
sweeps kernel G (``int4_matmul.route``) at the w4a8 draft's projections
(Qwen3-4B's widths): at decode (M 1 to 5 and 8) K split counts and warps
a block; at prefill (M 512, and
17, 64 and 130 rows) both tile widths and the split counts around the
policy's; every plan exact at unit scales with fp32 output. It also
sweeps kernel L's 16-byte vectors a thread and threads a block
(``silu_vjp.UNROLL``, ``THREADS``) at the train step's (4096, 9728) bf16
activation, forward and backward, beside ``F.silu`` and
``aten.silu_backward``, every launch shape equal bit for bit.

Run on a machine with a GPU and nvcc::

    python -m mojo_opset_tpu_torch.benchmark.split_sweep [int8 | int4]

It prints one JSON line; with ``int8`` or ``int4`` it sweeps F, or G and
L, alone.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import flce, int4_matmul, int8_matmul, paged_decode, silu_vjp
from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

H, HKV, D, PAGE = 32, 8, 128, 64
DECODE_CASES = (("main", [1032, 545, 162, 39], None, None), ("bs1_ctx4000", [4000], None, None),
                ("bs8_ctx4000", [4000] * 8, None, None), ("bs24_ctx4000", [4000] * 24, None, None),
                ("ctx32768", [32768] * 4, None, None), ("ctx32768_window", [32768] * 4, 1024, 64))
# (K, N) of the w8a8 projections: Qwen3-4B's q, k/v, o, gate/up, down; Seed-OSS-36B's q, k/v, o, gate/up, down
INT8_SHAPES = ((2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560),
               (5120, 10240), (5120, 1024), (10240, 5120), (5120, 27648), (27648, 5120))
INT8_PREFILL_M, INT8_DECODE_M = 1650, 8
# (K, N) of the w4a8 draft's int4 projections: Qwen3-4B's q, k/v, o, gate/up, down
INT4_SHAPES = INT8_SHAPES[:5]
SILU_SHAPE = (4096, 9728)


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


def int8_case(M, K, N, gen) -> dict:
    """F at one shape: every route or split count the shape can take, exact at unit scales with fp32 output, then
    timed with bf16 output and random scales (the ladder)."""
    dev = torch.device("cuda")
    x = torch.randint(-128, 128, (M, K), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), device=dev, generator=gen, dtype=torch.int8)
    ones_x, ones_w = torch.ones(M, device=dev), torch.ones(N, device=dev)
    xs, ws = torch.rand(M, device=dev, generator=gen) * 0.1, torch.rand(N, device=dev, generator=gen) * 1e-3
    lib = build.load_library()
    arrivals = torch.zeros(int8_matmul.ARRIVAL_SLOTS, dtype=torch.int32, device=dev)

    def run(code, splits, sx, sw, out, part):
        rc = lib.mojo_int8_matmul(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
                                  None if part is None else part.data_ptr(), arrivals.data_ptr(), M, N, K, 1, code,
                                  splits, build.DTYPE_CODES[out.dtype], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mojo_int8_matmul failed: CUDA error {rc}")

    policy = int8_matmul.route(M, N, K, True, build.sm_count(dev))
    if M > int8_matmul.DECODE_M:
        plans = [(code, 1) for code in (int8_matmul.WGMMA_128, int8_matmul.WGMMA_256)]
    else:
        k_tiles = -(-K // int8_matmul.DECODE_BK)
        counts = sorted({s for s in (1, 2, 3, 4, 5, 7, 10, 20, policy.splits) if s <= k_tiles})
        # only counts whose ranges of whole k-tiles leave none empty
        plans = [(int8_matmul.DECODE_MMA, s) for s in counts if -(-k_tiles // -(-k_tiles // s)) == s]
    want_exact = int8_matmul.int8_scaled_matmul_plain(x, w, ones_x, ones_w, True, torch.float32)
    want = int8_matmul.int8_scaled_matmul_plain(x, w, xs, ws, True, torch.bfloat16)
    result = {"policy": list(policy), "ms": {}}
    for code, splits in plans:
        part = (torch.empty(int8_matmul.split_scratch_ints(M, N, splits), dtype=torch.int32, device=dev)
                if splits > 1 else None)
        exact = torch.empty(M, N, device=dev)
        run(code, splits, ones_x, ones_w, exact, part)
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        run(code, splits, xs, ws, out, part)
        torch.cuda.synchronize()
        if not torch.equal(exact, want_exact):
            raise AssertionError(f"F M={M} K={K} N={N} route {code} splits {splits}: int32 sums differ")
        check_tol_diff(out, want, **tols_for(torch.bfloat16))
        result["ms"][f"{code}/{splits}"] = graph_ms(lambda: run(code, splits, xs, ws, out, part))  # noqa: B023
    if M > 16:
        result["int_mm_ms"] = graph_ms(lambda: torch._int_mm(x, w.t()))
    return result


def int8_report(gen) -> dict:
    cases = {f"{m}x{k}x{n}": (m, k, n) for k, n in INT8_SHAPES for m in (INT8_PREFILL_M, INT8_DECODE_M)}
    cases["4x2560x151936"] = (4, 2560, 151936)
    return {name: int8_case(m, k, n, gen) for name, (m, k, n) in cases.items()}


def int4_case(M, K, N, gen) -> dict:
    """G at one shape: the policy's plan and the plans around it, exact at unit scales with fp32 output, then timed
    with bf16 output and random scales (the ladder)."""
    dev = torch.device("cuda")
    x = torch.randint(-128, 128, (M, K), device=dev, generator=gen, dtype=torch.int8)
    wp = torch.randint(-128, 128, (N // 2, K), device=dev, generator=gen, dtype=torch.int8)
    ones_x, ones_w = torch.ones(M, device=dev), torch.ones(N, device=dev)
    xs, ws = torch.rand(M, device=dev, generator=gen) * 0.1, torch.rand(N, device=dev, generator=gen) * 1e-2
    lib = build.load_library()
    arrivals = torch.zeros(int8_matmul.ARRIVAL_SLOTS, dtype=torch.int32, device=dev)

    def run(plan, sx, sw, out, part):
        rc = lib.mojo_int4_matmul(x.data_ptr(), wp.data_ptr(), sx.data_ptr(), sw.data_ptr(), out.data_ptr(),
                                  None if part is None else part.data_ptr(), arrivals.data_ptr(), M, N, K, plan.code,
                                  plan.splits, plan.warps, build.DTYPE_CODES[out.dtype],
                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mojo_int4_matmul failed: CUDA error {rc}")

    policy = int4_matmul.route(M, N, K, build.sm_count(dev))
    R = int4_matmul.Route
    if M > int4_matmul.DECODE_M:
        k_tiles = -(-K // int4_matmul.PREFILL_BK)
        counts = {s for s in (1, 2, 3, 4, 5, 6, 8, policy.splits)
                  if s <= k_tiles and -(-k_tiles // -(-k_tiles // s)) == s}
        plans = [R(code, s) for code in (int4_matmul.WGMMA_128, int4_matmul.WGMMA_256) for s in sorted(counts)]
    else:
        k_steps = -(-K // int4_matmul.DECODE_STEP)
        counts = {s for s in (1, 2, 3, 4, 6, 8, policy.splits) if s <= k_steps and -(-k_steps // -(-k_steps // s)) == s}
        plans = sorted({R(int4_matmul.DECODE, s, w) for s in counts
                        for w in (4, 8, 16, int4_matmul.decode_warps(N, K, s, build.sm_count(dev)))} | {policy})
    want_exact = int4_matmul.int4_scaled_matmul_plain(x, wp, ones_x, ones_w, torch.float32)
    want = int4_matmul.int4_scaled_matmul_plain(x, wp, xs, ws, torch.bfloat16)
    result = {"policy": list(policy), "ms": {}}
    for plan in plans:
        part = (torch.empty(int4_matmul.split_scratch_ints(M, N, plan), dtype=torch.int32, device=dev)
                if plan.splits > 1 else None)
        exact = torch.empty(M, N, device=dev)
        run(plan, ones_x, ones_w, exact, part)
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        run(plan, xs, ws, out, part)
        torch.cuda.synchronize()
        if not torch.equal(exact, want_exact):
            raise AssertionError(f"G M={M} K={K} N={N} plan {tuple(plan)}: int32 sums differ")
        check_tol_diff(out, want, **tols_for(torch.bfloat16))
        result["ms"]["/".join(map(str, plan))] = graph_ms(lambda: run(plan, xs, ws, out, part))  # noqa: B023
    result["best"] = min(result["ms"], key=result["ms"].get)
    return result


def silu_case(gen) -> dict:
    """L's forward and backward at every launch shape the kernel takes, equal bit for bit, beside the library."""
    x = torch.randn(SILU_SHAPE, device="cuda", generator=gen).bfloat16()
    dy = torch.randn(SILU_SHAPE, device="cuda", generator=gen).bfloat16()
    result, first, chosen = {"fwd": {}, "bwd": {}}, {}, (silu_vjp.UNROLL, silu_vjp.THREADS)
    for unroll in (2, 4):
        for threads in (128, 256, 512):
            silu_vjp.UNROLL, silu_vjp.THREADS = unroll, threads
            for name, fn in (("fwd", lambda: silu_vjp.silu_fwd(x)), ("bwd", lambda: silu_vjp.silu_bwd(x, dy))):
                got = fn()
                if not torch.equal(got, first.setdefault(name, got)):
                    raise AssertionError(f"L {name} unroll {unroll} threads {threads} differs from the first shape")
                result[name][f"{unroll}/{threads}"] = graph_ms(fn)
    silu_vjp.UNROLL, silu_vjp.THREADS = chosen
    result["fwd"]["library"] = graph_ms(lambda: torch.nn.functional.silu(x))
    result["bwd"]["library"] = graph_ms(lambda: torch.ops.aten.silu_backward(dy, x))
    return result


def int4_report(gen) -> dict:
    cases = {f"{m}x{k}x{n}": (m, k, n) for k, n in INT4_SHAPES for m in (1, 2, 3, 4, 5, 8, 512)}
    cases.update({f"{m}x{k}x{n}": (m, k, n) for k, n in INT4_SHAPES[:3] for m in (17, 64, 130)})
    return {name: int4_case(m, k, n, gen) for name, (m, k, n) in cases.items()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("split_sweep needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if sys.argv[1:] == ["int8"]:
        report = {"int8_matmul": int8_report(gen)}
    elif sys.argv[1:] == ["int4"]:
        report = {"int4_matmul": int4_report(gen), "silu": silu_case(gen)}
    else:
        report = {"decode": {name: decode_case(lens, local, glob, gen) for name, lens, local, glob in DECODE_CASES}}
        torch.cuda.empty_cache()
        report["flce_dx"] = dx_case(gen)
        report["int8_matmul"] = int8_report(gen)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    report["card"] = smi[0] if smi else None
    print(json.dumps(report))


if __name__ == "__main__":
    main()
