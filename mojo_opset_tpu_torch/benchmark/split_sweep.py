"""Kernel C's split count, kernel N's dx K ranges, kernel F's, G's and R's routes, kernel L's, B's, K's and Q's
launch shapes, swept at the smoke's shapes.

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
``aten.silu_backward``, every launch shape equal bit for bit. ``mla``
sweeps kernel I's column tile and split count (``mla_decode.column_tile``,
``mla_decode.split_count``) at DeepSeek-V3's widths (H 128, r 512, dr 64,
bf16, pages of 64): the smoke's decode at bs 4 and bs 1 (contexts 1001,
514, 131, 8), bs 1 at ctx 4096 and 32768, bs 24 at ctx 4000; a narrower
column tile gives more blocks a row, so fewer splits fill the card, at
the cost of reading the latent once for each column block. Every plan is
held to the plain version on the fp32 ladder. ``rope`` times kernel B's
vector route at both block sizes it takes (``rope.THREADS``: 128 or 256
threads) on q and k at the prefill batch (1650 tokens) with Qwen3-4B's
32/8 heads and Seed-OSS-36B's 80/8, D 128, at decode rows (T 4 and 1 at
32/8) and on DeepSeek-V3's rope lanes (T 4, 128/1 heads, D 64), bf16,
every block size equal bit for bit. ``rmsnorm_bwd`` times kernel K's
register route at the train step's norms ((4096, 2560), (131072, 128) and
(32768, 128), bf16; A's layouts, ``norms.row_layout``) at each count of
blocks an SM up to what the card holds (the grid,
``rmsnorm_vjp.blocks_per_sm``), beside the generic kernels: device ms from a
CUDA graph, and from a profiled window the row pass's and the column sum's
ms, with each kernel's registers and blocks an SM; every result within the
dtype ladder of the plain version. ``conv1d`` times kernel Q's exact-width
route (W 4, SiLU, bf16) at the conv Function's shape (B 8, T 8192, D 2048)
and the perf descriptor's (T 2048), forward and backward, at each ring depth,
block size and prefetch choice it instantiates (``conv1d_vjp.RING``,
``THREADS``, ``PREFETCH``) and chunks of 64, 128 and 256 rows
(``conv1d_vjp.CHUNK``), and at the plan's own chunk; every out and dx equal
bit for bit, dw and db within the fp32 ladder; the backward's row pass and
column sum apart, the forward and backward without the SiLU beside, and
each kernel's registers and blocks an SM. ``gqmm`` times each of kernel R's
routes (``group_quant_gemm.TILES``) at the quantized MoE experts' shapes
(Qwen3-30B-A3B's fc1 and down, G 128, int8 and int4; DeepSeek-V3's, G
256, int8) for the rows of a top-8 routing at 32, 52, 64 and 103 rows a
group on average at G 128 (103: the smoke's prefill batch) and 32 and 52 at
G 256 (52: the same batch), every route equal to the plain version bit for
bit; ``route`` picks from these readings.

Run on a machine with a GPU and nvcc::

    python -m mojo_opset_tpu_torch.benchmark.split_sweep [int8 | int4 | mla | rope | rmsnorm_bwd | conv1d | gqmm]

It prints one JSON line; with ``int8``, ``int4``, ``mla``, ``rope``,
``rmsnorm_bwd``, ``conv1d`` or ``gqmm`` it sweeps F, G and L, I alone, B
alone, K alone, Q alone or R alone.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import torch

from mojo_opset_tpu_torch.backends.cuda import build
from mojo_opset_tpu_torch.backends.cuda.kernels import (
    conv1d_vjp, flce, group_quant_gemm, int4_matmul, int8_matmul, mla_decode, norms, paged_decode, rmsnorm_vjp, rope,
    silu_vjp,
)
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


# (tokens, q heads, k heads, head dim) of kernel B's sweep
ROPE_CASES = ((1650, 32, 8, 128), (1650, 80, 8, 128), (4, 32, 8, 128), (1, 32, 8, 128), (4, 128, 1, 64))


def rope_case(n, hq, hk, d, gen) -> dict:
    """B's vector route at each block size, equal bit for bit, beside the generic route's one (rope.THREADS set
    around the wrapper; the generic kernel through the C entry point)."""
    bf16 = torch.bfloat16
    q = torch.randn(n, hq, d, device="cuda", generator=gen).to(bf16)
    k = torch.randn(n, hk, d, device="cuda", generator=gen).to(bf16)
    ang = torch.rand(n, d, device="cuda", generator=gen) * 6
    cos, sin = ang.cos().to(bf16), ang.sin().to(bf16)
    assert rope.route(q, k, cos, sin) == "vector"
    result, first, chosen = {}, None, rope.THREADS
    for threads in (128, 256):
        rope.THREADS = threads
        run = lambda: rope.rope_token_first(q, k, cos, sin)  # noqa: E731
        got = torch.cat([t.flatten() for t in run()])
        first = got if first is None else first
        if not torch.equal(got, first):
            raise AssertionError(f"B at {threads} threads differs from 128 threads")
        result[threads] = graph_ms(run)
    rope.THREADS = chosen
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)

    def generic():
        build.launch("mojo_rope_token_first", q.device, q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                     q_out.data_ptr(), k_out.data_ptr(), n, hq, hk, d, 0, 0, build.dtype_code(q))
        return q_out, k_out

    if not torch.equal(torch.cat([t.flatten() for t in generic()]), first):
        raise AssertionError("B's generic route differs from its vector route")
    result["generic"] = graph_ms(generic)
    return result


MLA_CASES = (("bs4", [1001, 514, 131, 8]), ("bs1", [1001]), ("bs1_ctx4096", [4096]), ("bs1_ctx32768", [32768]),
             ("bs24_ctx4000", [4000] * 24))


def mla_case(lens, gen) -> dict:
    """Kernel I through its wrapper with ``column_tile`` and ``split_count`` forced to each plan, keyed
    ``tile/splits``."""
    dev, bf16, r, dr, H = torch.device("cuda"), torch.bfloat16, 512, 64, 128
    cols = max(17, -(-max(lens) // PAGE))
    n_pages = max(4 * 17 + 4, sum(-(-n // PAGE) for n in lens) + 4)
    c = torch.randn(n_pages, 1, PAGE, r, device=dev, generator=gen).to(bf16)
    pe = torch.randn(n_pages, 1, PAGE, dr, device=dev, generator=gen).to(bf16)
    perm = torch.randperm(n_pages, device=dev, generator=gen).tolist()
    rows, used = [], 0
    for n in lens:
        need = -(-n // PAGE)
        rows.append(perm[used:used + need] + [-1] * (cols - need))
        used += need
    table = torch.tensor(rows, dtype=torch.int32, device=dev)
    limits = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_lat = (torch.randn(len(lens), H, r, device=dev, generator=gen) * 0.05).to(bf16)
    q_pe = (torch.randn(len(lens), H, dr, device=dev, generator=gen) * 0.05).to(bf16)
    want = mla_decode.mla_decode_absorbed_plain(q_lat, q_pe, c, pe, limits, table)
    policy = mla_decode.split_count(len(lens), H, r, cols * PAGE, build.sm_count(dev))
    result = {"policy": f"{mla_decode.column_tile(r)}/{policy}", "ms": {}}
    forced = mla_decode.column_tile, mla_decode.split_count
    try:
        for tile in mla_decode.COLUMN_TILES:
            for splits in sorted({1, 2, 4, 8, 16, 32, 66, 132, policy}):
                if splits > mla_decode.MAX_SPLITS:
                    continue
                mla_decode.column_tile = lambda *_, n=tile: n
                mla_decode.split_count = lambda *_, n=splits: n
                run = lambda: mla_decode.mla_decode_absorbed(q_lat, q_pe, c, pe, limits, table)  # noqa: E731
                check_tol_diff(run(), want, **tols_for(torch.float32))
                result["ms"][f"{tile}/{splits}"] = graph_ms(run)
    finally:
        mla_decode.column_tile, mla_decode.split_count = forced
    result["best"] = min(result["ms"], key=result["ms"].get)
    return result


def kernel_ms(fn, names, calls: int = 10) -> dict:
    """Device ms a call of each kernel whose name holds one of ``names``, over ``calls`` profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {n: sum(e.self_device_time_total for e in events if n in e.key) / 1e3 / calls for n in names}


RMSNORM_BWD_CASES = ((4096, 2560), (131072, 128), (32768, 128))


def rmsnorm_bwd_case(rows, D, gen) -> dict:
    """K's register route at each count of blocks an SM, and the generic kernels (the entry point with no layout),
    each held to the plain version; keyed by blocks an SM."""
    dev, bf16, eps = torch.device("cuda"), torch.bfloat16, 1e-6
    x = torch.randn(rows, D, device=dev, generator=gen).to(bf16)
    dy = torch.randn(rows, D, device=dev, generator=gen).to(bf16)
    w = torch.rand(D, device=dev, generator=gen) + 0.5
    want = rmsnorm_vjp.rmsnorm_bwd_plain(x, w, dy, eps)
    names = ("rmsnorm_bwd_", "mojo_column_sum_kernel")
    tpr, vpt = rmsnorm_vjp.layout(x, dy, w)
    result = {"layout": (tpr, vpt), "policy": rmsnorm_vjp.blocks_per_sm(tpr, vpt, bf16), "ms": {}, "split": {},
              "resources": {"regs": build.resources("mojo_rmsnorm_bwd_resources", D, 1, tpr, vpt,
                                                    build.DTYPE_CODES[bf16])}}
    chosen = rmsnorm_vjp.blocks_per_sm
    try:
        for bps in range(1, result["resources"]["regs"]["blocks_per_sm"] + 1):
            rmsnorm_vjp.blocks_per_sm = lambda *_, n=bps: n
            run = lambda: rmsnorm_vjp.rmsnorm_bwd(x, w, dy, eps)  # noqa: E731
            for got, ref in zip(run(), want):
                check_tol_diff(got, ref, **tols_for(bf16))
            result["ms"][bps] = graph_ms(run)
            result["split"][bps] = kernel_ms(run, names)
    finally:
        rmsnorm_vjp.blocks_per_sm = chosen
    blocks = rmsnorm_vjp.grid_blocks(rows, D, bf16, None, build.sm_count(dev))
    part = torch.empty(blocks, D, device=dev)
    dx, dw = torch.empty_like(x), torch.empty(D, device=dev)

    def generic():
        build.launch("mojo_rmsnorm_bwd", dev, x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                     part.data_ptr(), dw.data_ptr(), rows, D, eps, blocks, 1, 0, 0, build.DTYPE_CODES[bf16])
        return dx, dw

    for got, ref in zip(generic(), want):
        check_tol_diff(got, ref, **tols_for(bf16))
    result["ms"]["generic"] = graph_ms(generic)
    result["split"]["generic"] = kernel_ms(generic, names)
    result["resources"]["generic"] = build.resources("mojo_rmsnorm_bwd_resources", D, 1, 0, 0,
                                                     build.DTYPE_CODES[bf16])
    result["best"] = min(result["ms"], key=result["ms"].get)
    return result


CONV_CASES = ((8, 8192, 2048), (8, 2048, 2048))
# (rows loaded ahead, threads a block, prefetch) of the exact-width kernel that csrc/conv1d.cu instantiates for
# bf16 at W 4
CONV_VARIANTS = ((4, 128, 0), (8, 128, 0), (2, 128, 1), (4, 64, 1), (4, 128, 1), (4, 256, 1))


def conv1d_case(B, T, D, gen) -> dict:
    """Q's exact-width route at W 4 (bf16, SiLU) at each variant and chunk, keyed ``ring/threads/prefetch/chunk``
    (``plan``: the plan's own chunk), forward and backward; without the SiLU at the chosen variant."""
    dev, bf16, W = torch.device("cuda"), torch.bfloat16, 4
    x = torch.randn(B, T, D, device=dev, generator=gen).to(bf16)
    g = torch.randn(B, T, D, device=dev, generator=gen).to(bf16)
    w = torch.randn(D, W, device=dev, generator=gen) * 0.3
    b = torch.randn(D, device=dev, generator=gen) * 0.1
    st = torch.randn(B, W - 1, D, device=dev, generator=gen).to(bf16)
    ref_out = conv1d_vjp.conv1d_fwd_plain(x, w, b, st, True)
    ref_dx, ref_dw, ref_db = conv1d_vjp.conv1d_bwd_plain(x, w, b, st, g, True)
    chosen = (conv1d_vjp.RING, conv1d_vjp.THREADS, conv1d_vjp.PREFETCH, conv1d_vjp.CHUNK, conv1d_vjp.MIN_CHUNK)
    result = {"policy": "/".join(map(str, chosen[:3])) + "/plan", "fwd": {}, "bwd": {}, "bwd_split": {},
              "resources": {}}
    first = None
    try:
        for ring, threads, prefetch in CONV_VARIANTS:
            conv1d_vjp.RING, conv1d_vjp.THREADS, conv1d_vjp.PREFETCH = ring, threads, prefetch
            tag = f"{ring}/{threads}/{prefetch}"
            result["resources"][tag] = {
                d: build.resources("mojo_conv1d_resources", W, 1, int(d == "bwd"), ring, threads, prefetch,
                                   build.DTYPE_CODES[bf16]) for d in ("fwd", "bwd")}
            for chunk in (64, 128, 256, "plan"):
                conv1d_vjp.CHUNK, conv1d_vjp.MIN_CHUNK = (chosen[3:] if chunk == "plan" else (chunk, chunk))
                fwd = lambda: conv1d_vjp.conv1d_fwd(x, w, b, st, True)  # noqa: E731
                bwd = lambda: conv1d_vjp.conv1d_bwd(x, w, b, st, g, True)  # noqa: E731
                out, (dx, dw, db) = fwd(), bwd()
                if first is None:
                    first = out, dx
                    check_tol_diff(out, ref_out, **tols_for(bf16))
                    check_tol_diff(dx, ref_dx, **tols_for(bf16))
                if not (torch.equal(out, first[0]) and torch.equal(dx, first[1])):
                    raise AssertionError(f"Q {tag}/{chunk}: out or dx differs from the first variant's")
                check_tol_diff(dw, ref_dw, **tols_for(torch.float32))
                check_tol_diff(db, ref_db, **tols_for(torch.float32))
                key = f"{tag}/{chunk}"
                result["fwd"][key], result["bwd"][key] = graph_ms(fwd), graph_ms(bwd)
                if chunk == "plan":
                    result["bwd_split"][tag] = kernel_ms(bwd, ("conv1d_bwd_exact_kernel", "mojo_column_sum_kernel"))
    finally:
        (conv1d_vjp.RING, conv1d_vjp.THREADS, conv1d_vjp.PREFETCH, conv1d_vjp.CHUNK,
         conv1d_vjp.MIN_CHUNK) = chosen
    result["no_silu"] = {"fwd": graph_ms(lambda: conv1d_vjp.conv1d_fwd(x, w, b, st, False)),
                         "bwd": graph_ms(lambda: conv1d_vjp.conv1d_bwd(x, w, b, st, g, False))}
    result["best_fwd"] = min(result["fwd"], key=result["fwd"].get)
    result["best_bwd"] = min(result["bwd"], key=result["bwd"].get)
    return result


# R: (name, G, K, N, int4) of the quantized experts' products, and the rows a group holds on average
GQMM_SHAPES = (("qwen_fc1", 128, 2048, 1536, False), ("qwen_down", 128, 768, 2048, False),
               ("qwen_fc1_int4", 128, 2048, 1536, True), ("qwen_down_int4", 128, 768, 2048, True),
               ("deepseek_fc1", 256, 7168, 4096, False), ("deepseek_down", 256, 2048, 7168, False))
GQMM_ROWS_PER_GROUP = {128: (32, 52, 64, 103), 256: (32, 52)}


def gqmm_case(G, K, N, int4, rows, gen) -> dict:
    """Each of R's routes on one top-8 routing of ``rows`` rows: device ms from a CUDA graph, bit for bit against
    the plain version, and the policy's choice."""
    rng = np.random.default_rng(rows)
    choice = np.argsort(rng.random((rows // 8, G)), axis=1)[:, :8]
    counts = torch.tensor(np.bincount(choice.reshape(-1), minlength=G), dtype=torch.int32, device="cuda")
    x = torch.randint(-128, 128, (rows, K), device="cuda", generator=gen, dtype=torch.int8)
    w = torch.randint(-8, 8, (G, N // 2, K), device="cuda", generator=gen, dtype=torch.int8) if int4 else \
        torch.randint(-127, 128, (G, N, K), device="cuda", generator=gen, dtype=torch.int8)
    ws = torch.rand(G, N, device="cuda", generator=gen) * 0.01 + 1e-3
    xs = torch.rand(rows, 1, device="cuda", generator=gen) * 0.05 + 1e-3
    want = group_quant_gemm.grouped_quant_matmul_plain(x, w, counts, ws, xs, torch.bfloat16, int4)
    out = torch.empty_like(want)
    result = {"policy": group_quant_gemm.ROUTE_NAMES[group_quant_gemm.route(rows, G, int4)]}

    for code, name in group_quant_gemm.ROUTE_NAMES.items():
        n_scratch = group_quant_gemm.scratch_ints(rows, G, code)
        scratch = torch.empty(max(n_scratch, 1), dtype=torch.int32, device="cuda")

        def run(code=code, scratch=scratch, n_scratch=n_scratch):
            build.launch("mojo_group_quant_gemm", x.device, x.data_ptr(), w.data_ptr(), counts.data_ptr(),
                         xs.data_ptr(), ws.data_ptr(), out.data_ptr(), scratch.data_ptr() if n_scratch else None,
                         n_scratch, rows, N, K, G, int(int4), code, build.DTYPE_CODES[torch.bfloat16])

        run()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"R's {name} route differs from the plain version at G {G} K {K} N {N} rows {rows}")
        result[name] = graph_ms(run)
    return result


def gqmm_report(gen) -> dict:
    report = {}
    for name, G, K, N, int4 in GQMM_SHAPES:
        for per_group in GQMM_ROWS_PER_GROUP[G]:
            report[f"{name}_{per_group}"] = gqmm_case(G, K, N, int4, per_group * G, gen)
        torch.cuda.empty_cache()
    return report


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
    elif sys.argv[1:] == ["rope"]:
        report = {"rope": {f"{n}x{hq}x{hk}x{d}": rope_case(n, hq, hk, d, gen) for n, hq, hk, d in ROPE_CASES}}
    elif sys.argv[1:] == ["mla"]:
        report = {"mla_decode": {name: mla_case(lens, gen) for name, lens in MLA_CASES}}
    elif sys.argv[1:] == ["rmsnorm_bwd"]:
        report = {"rmsnorm_bwd": {f"{r}x{d}": rmsnorm_bwd_case(r, d, gen) for r, d in RMSNORM_BWD_CASES}}
    elif sys.argv[1:] == ["conv1d"]:
        report = {"conv1d": {f"b{b}_t{t}_d{d}": conv1d_case(b, t, d, gen) for b, t, d in CONV_CASES}}
    elif sys.argv[1:] == ["gqmm"]:
        report = {"group_quant_gemm": gqmm_report(gen)}
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
