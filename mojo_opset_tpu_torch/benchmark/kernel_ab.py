"""Kernels D (paged prefill), H (grouped GEMM), F (int8 GEMM), A (RMSNorm), P (residual add + RMSNorm), G
(packed-int4 GEMM), L (SiLU), B (token-first RoPE), E (RMSNorm + int8 quant), K (RMSNorm backward), Q (causal
conv1d), R (int8 / int4 grouped GEMM), I (absorbed MLA) and the dk/dv entry points of J and O of one tree, and the
paths and the train step on them, for comparing two trees on one card.

The kernels come from the ``mojo_opset_tpu_torch`` package that ``sys.path``
finds first: this tree's, or another commit's (``git archive`` unpacked in
a directory) put first with ``PYTHONPATH``. The cases are this tree's
``chip_smoke.py`` (loaded from its file):

- ``readings``: phase 3's D and H cases (``_prefill_cases``,
  ``_gmm_cases``) with ``PAGED_PREFILL_REL_LIMITS`` and
  ``GROUP_GEMM_REL_LIMITS`` lifted, so each case prints its relative errors
  against the plain version (whole tensor, worst row) and nothing fails on
  them; the dtype ladder and the bit-for-bit repeats still hold.
- ``times TAG``: one line ``TAG name ms ...`` of the main cases' device
  times, 20 calls replayed from a CUDA graph: D and D' at the smoke's
  prefill batch (Qwen3-4B's 32/8 heads, D 128, bf16, pages of 64), H's fc1
  and down at Qwen3-30B-A3B's prefill (13200 rows) and decode (32 rows),
  and at G = 256 (DeepSeek-V3's experts) at prefill; F at Qwen3-4B's
  gate/up and k/v projections at prefill (1650 rows) and decode (8 rows)
  and Seed-OSS-36B's down projection at prefill, bf16 output; A at
  Qwen3-4B's layer norm (1650, 2560), its q and k head norms (1650 x 32
  and 1650 x 8 rows of 128) and the Wan DiT's (4400, 3072); P pre and post
  at (1650, 2560), 4096 x 4096 and 8192 x 8192, bf16; G at the w4a8
  projections and L at the train step's activation; B on q and k at the
  prefill batch (1650 tokens) with Qwen3-4B's 32/8 heads and Seed-OSS-36B's
  80/8, D 128, at decode rows (T 4 and 1 at 32/8, T 4 at 80/8) and on
  DeepSeek-V3's rope lanes (T 4, 128/1 heads, D 64); E at (1650, 2560),
  (4, 2560), (1, 2560), (8, 2560) with a zero row, (4, 5120) and (1650,
  5120), bf16; K at the train step's norms ((4096, 2560), (131072, 128)
  and (32768, 128), bf16) and Q's forward and backward at the conv
  Function's shape (B 8, T 8192, D 2048, W 4, SiLU, bf16) and at T 2048;
  R at phase 3's main shapes (Qwen3-30B-A3B's fc1 and down at decode, 32
  rows, and prefill, 13200 rows, int8 and int4; DeepSeek-V3's, int8; bf16
  output; a tree without R skips it). A second line gives the digest of
  each output of G, L, B, E, K, Q and R (B's q and k together, E's int8
  values and scales apart, K's dx and dw apart, Q's out, dx, dw and db
  apart). ``times TAG DIR`` also saves B's, E's, K's, Q's and R's outputs
  to ``DIR/TAG.pt`` (~1.8 GB: keep DIR out of what a run copies back).
- ``ulps DIR TAG_A TAG_B``: for each output saved by two ``times`` runs,
  how many elements differ and by how many ulps at most (float outputs,
  ordered by their bits), or by how many steps (int8).
- ``host TAG``: the host microseconds of one G call at M = 1 at the w4a8
  draft's five projections (2000 eager calls on the host clock after a
  warm-up; the kernel's few microseconds are shorter, so the host paces
  the loop) and of its ``route`` alone; then ``mla``'s first three cases
  and phase 7 (bs-1 w4a8 speculative decoding at full width).
- ``mla TAG``: I (absorbed MLA, DeepSeek-V3's H 128, r 512, dr 64, bf16,
  pages of 64) at the smoke's decode bs 4 and bs 1 and prefill row mode,
  decode bs 1 at ctx 4096 and 32768 and bs 24 at ctx 4000: device ms from
  a CUDA graph, and from one profiled call the device ms of each CUDA
  kernel it launched (the tile kernel, the split merge), with the output's
  digest.
- ``dkv TAG``: J's dk/dv at the training shape (B 2 x S 2048, 32/8 heads,
  D 128, causal) in bf16 and fp16 and at group 65 (130/2 heads, D 64,
  sequences of 200 and 3) in fp16, and O's at the diffusion Function's
  shape (B 2, 16 heads, S 4096, D 128, block_diffusion_mask(4096, 64)) in
  bf16 and fp16: device ms from a CUDA graph and each output's error
  relative to its size against the plain version (whole tensor), fed the
  plain forward's lse and delta.
- ``train TAG``: this tree's phase 10 (Qwen3 training at Qwen3-4B
  geometry, 36 layers, its 5 timed steps) and phase 15 (the conv Function
  on Q) on the tree's kernels; then one line ``TAG train ...``: the mean
  step ms of the 5 steps (forward + loss, backward, AdamW), the profiled
  step's device busy ms and kernel K's device ms in it (its row kernels
  and its column sum), and the conv Function's ms a forward + backward
  call on Q, in each of phase 15's two forms.
- ``paths TAG``: this tree's phases 5 (Qwen3-4B bf16), 6 (Qwen3-4B w8a8 +
  C8), 7 (bs-1 w4a8 speculative) and 11 (Seed-OSS-36B cut to 32 layers,
  bf16 and w8a8) on the tree's kernels, each printing its prefill and
  decode times and one profiled prefill (device busy ms, the largest hand
  kernels' shares).

Run on a machine with a GPU and nvcc, in turns (parent, change, change,
parent) within one call::

    PYTHONPATH=. python3 mojo_opset_tpu_torch/benchmark/kernel_ab.py times change
    PYTHONPATH=<parent tree> python3 mojo_opset_tpu_torch/benchmark/kernel_ab.py times parent
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import torch


def load_chip_smoke():
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def readings(s) -> None:
    lifted = {k: (math.inf, math.inf) for k in ("bf16", "fp16", "fp32")}
    s.PAGED_PREFILL_REL_LIMITS, s.GROUP_GEMM_REL_LIMITS = lifted, dict(lifted)
    gen = torch.Generator(device="cuda").manual_seed(1)
    record = {}
    compare = s.make_compare(torch, record)
    s._prefill_cases(torch, compare, gen, record)
    s._gmm_cases(torch, compare, gen, record)


# B's cases (tokens, q heads, k heads, head dim) and E's (rows, width)
ROPE_CASES = ((1650, 32, 8, 128), (1650, 80, 8, 128), (4, 32, 8, 128), (1, 32, 8, 128), (4, 80, 8, 128),
              (4, 128, 1, 64))
RMSNORM_QUANT_CASES = ((1650, 2560), (4, 2560), (1, 2560), (8, 2560), (4, 5120), (1650, 5120))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def rope_and_quant(s, out: dict, digests: dict, saved: dict) -> None:
    """B's and E's cases (bf16), on inputs of their own generator: times into ``out``, outputs' digests into
    ``digests``, the outputs into ``saved``."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import rmsnorm_quant, rope

    gen = torch.Generator(device="cuda").manual_seed(17)
    bf16 = torch.bfloat16
    for n, hq, hk, d in ROPE_CASES:
        q = torch.randn(n, hq, d, device="cuda", generator=gen).to(bf16)
        k = torch.randn(n, hk, d, device="cuda", generator=gen).to(bf16)
        ang = torch.arange(n, device="cuda", dtype=torch.float32)[:, None] * (
            1.0 / 10000 ** (torch.arange(0, d, 2, device="cuda") / d))
        cos, sin = torch.cat([ang, ang], -1).cos().to(bf16), torch.cat([ang, ang], -1).sin().to(bf16)
        run = lambda: rope.rope_token_first(q, k, cos, sin)  # noqa: E731
        name = f"B_{n}x{hq}x{hk}x{d}"
        out[name] = s.graph_ms(torch, run)
        q_out, k_out = run()
        saved[name] = torch.cat([q_out.flatten(), k_out.flatten()])
        digests[name] = digest(saved[name])
    for rows, D in RMSNORM_QUANT_CASES:
        x = torch.randn(rows, D, device="cuda", generator=gen).to(bf16)
        if rows == 8:
            x[1] = 0
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        run = lambda: rmsnorm_quant.rmsnorm_quant(x, w, 1e-6)  # noqa: E731
        name = f"E_{rows}x{D}"
        out[name] = s.graph_ms(torch, run)
        saved[name + "_q"], saved[name + "_scale"] = run()
        digests[name + "_q"], digests[name + "_scale"] = digest(saved[name + "_q"]), digest(saved[name + "_scale"])


# K's cases (rows, width) and Q's (B, T, D; W 4, SiLU)
RMSNORM_BWD_CASES = ((4096, 2560), (131072, 128), (32768, 128))
CONV_CASES = ((8, 8192, 2048), (8, 2048, 2048))


def backward_kernels(s, out: dict, digests: dict, saved: dict) -> None:
    """K's and Q's cases (bf16), on inputs of their own generator: times into ``out``, outputs' digests into
    ``digests``, the outputs into ``saved``."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import conv1d_vjp, rmsnorm_vjp

    gen = torch.Generator(device="cuda").manual_seed(18)
    bf16 = torch.bfloat16
    for rows, D in RMSNORM_BWD_CASES:
        x, dy = (torch.randn(rows, D, device="cuda", generator=gen).to(bf16) for _ in range(2))
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        run = lambda: rmsnorm_vjp.rmsnorm_bwd(x, w, dy, 1e-6)  # noqa: E731
        name = f"K_{rows}x{D}"
        out[name] = s.graph_ms(torch, run)
        saved[name + "_dx"], saved[name + "_dw"] = run()
    for B, T, D in CONV_CASES:
        x, g = (torch.randn(B, T, D, device="cuda", generator=gen).to(bf16) for _ in range(2))
        w = torch.randn(D, 4, device="cuda", generator=gen) * 0.3
        b = torch.randn(D, device="cuda", generator=gen) * 0.1
        st = torch.randn(B, 3, D, device="cuda", generator=gen).to(bf16)
        fwd = lambda: conv1d_vjp.conv1d_fwd(x, w, b, st, True)  # noqa: E731
        bwd = lambda: conv1d_vjp.conv1d_bwd(x, w, b, st, g, True)  # noqa: E731
        name = f"Q_b{B}_t{T}"
        out[name + "_fwd"], out[name + "_bwd"] = s.graph_ms(torch, fwd), s.graph_ms(torch, bwd)
        saved[name + "_out"] = fwd()
        saved[name + "_dx"], saved[name + "_dw"], saved[name + "_db"] = bwd()
        del x, g
    digests.update({k: digest(v) for k, v in saved.items() if k.startswith(("K_", "Q_"))})


# R's cases at phase 3's main shapes: (name, G, rows, K, N, int4), decode (32 rows) and prefill (13200 rows) of
# Qwen3-30B-A3B's experts (int8 and int4) and DeepSeek-V3's (int8)
GQMM_EXPERTS = {"qwen": (128, ((2048, 1536, "fc1"), (768, 2048, "down"))),
                "deepseek": (256, ((7168, 4096, "fc1"), (2048, 7168, "down")))}
GQMM_CASES = tuple((f"R_{model}_{phase}_{stage}{'_int4' if int4 else ''}", GQMM_EXPERTS[model][0], rows, K, N, int4)
                   for model, int4 in (("qwen", False), ("qwen", True), ("deepseek", False))
                   for phase, rows in (("decode", 32), ("prefill", 13200))
                   for K, N, stage in GQMM_EXPERTS[model][1])


def grouped_quant(s, out: dict, digests: dict, saved: dict) -> None:
    """R's cases (bf16 output), on inputs of their own generator and routing: times into ``out``, outputs'
    digests into ``digests``, the outputs into ``saved``. A tree without kernel R skips them."""
    try:
        from mojo_opset_tpu_torch.backends.cuda.kernels import group_quant_gemm
    except ImportError:
        return
    gen = torch.Generator(device="cuda").manual_seed(19)
    rng = np.random.default_rng(19)
    for name, G, rows, K, N, int4 in GQMM_CASES:
        choice = np.argsort(rng.random((rows // 8, G)), axis=1)[:, :8]  # a random top-8 routing
        counts = torch.tensor(np.bincount(choice.reshape(-1), minlength=G), dtype=torch.int32, device="cuda")
        x = torch.randint(-128, 128, (rows, K), device="cuda", generator=gen, dtype=torch.int8)
        w = torch.randint(-128, 128, (G, N // 2 if int4 else N, K), device="cuda", generator=gen, dtype=torch.int8)
        ws = torch.rand(G, N, device="cuda", generator=gen) * 0.01 + 1e-3
        xs = torch.rand(rows, 1, device="cuda", generator=gen) * 0.05 + 1e-3
        run = lambda: group_quant_gemm.grouped_quant_matmul(x, w, counts, ws, xs, torch.bfloat16, int4)  # noqa: E731
        out[name] = s.graph_ms(torch, run)
        saved[name] = run()
        digests[name] = digest(saved[name])
        del w
        torch.cuda.empty_cache()


def times(s, tag: str, save_dir: str | None = None) -> None:
    from mojo_opset_tpu_torch.backends.cuda.kernels import (
        group_gemm, int4_matmul, int8_matmul, norms, paged_prefill, silu_vjp,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, lens, n_blocks = torch.bfloat16, list(s.PROMPT_LENS), 4 * 69
    cu = s._cu(torch, lens)
    out = {}
    kc, vc = s._cache(torch, n_blocks, 8, s.BLOCK_SIZE, 128, "NHD", bf16, gen)
    bt = s._tables(torch, lens, s.BLOCK_SIZE, 69, n_blocks, gen)
    q = torch.randn(sum(lens), 32, 128, device="cuda", generator=gen).to(bf16)
    out["D"] = s.graph_ms(torch, lambda: paged_prefill.paged_prefill_gqa(q, kc, vc, cu, bt, None, cu, "AABB", "NHD",
                                                                         max_q_len=max(lens)))
    (k8, v8), (ks, vs) = s._int8_cache(torch, n_blocks, 8, s.BLOCK_SIZE, 128, gen)
    out["D_int8"] = s.graph_ms(torch, lambda: paged_prefill.paged_prefill_gqa(
        q, k8, v8, cu, bt, None, cu, "AABB", "HND", max_q_len=max(lens), key_scale=ks, value_scale=vs))
    rng = np.random.default_rng(2)
    for name, G, M, K, N in (("H_fc1", 128, 13200, 2048, 1536), ("H_down", 128, 13200, 768, 2048),
                             ("H_decode_fc1", 128, 32, 2048, 1536), ("H_decode_down", 128, 32, 768, 2048),
                             ("H_g256_fc1", 256, 13200, 7168, 4096), ("H_g256_down", 256, 13200, 2048, 7168)):
        choice = np.argsort(rng.random((M // 8, G)), axis=1)[:, :8]  # a random top-8 routing
        counts = torch.tensor(np.bincount(choice.reshape(-1), minlength=G), dtype=torch.int32, device="cuda")
        x = torch.randn(M, K, device="cuda", generator=gen).to(bf16)
        w = torch.randn((G, N, K), device="cuda", generator=gen, dtype=bf16).mul_(0.05)
        out[name] = s.graph_ms(torch, lambda: group_gemm.grouped_matmul(x, w, counts, True))
        del w
        torch.cuda.empty_cache()
    for M, K, N in ((1650, 2560, 9728), (1650, 2560, 1024), (1650, 27648, 5120), (8, 2560, 9728), (8, 2560, 1024)):
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
        xs, ws = torch.rand(M, 1, device="cuda", generator=gen), torch.rand(N, device="cuda", generator=gen)
        out[f"F_{M}x{K}x{N}"] = s.graph_ms(torch, lambda: int8_matmul.int8_scaled_matmul(x, w, xs, ws, True, bf16))
    for rows, D in ((1650, 2560), (1650 * 32, 128), (1650 * 8, 128), (4400, 3072)):
        x = torch.randn(rows, D, device="cuda", generator=gen).to(bf16)
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        out[f"A_{rows}x{D}"] = s.graph_ms(torch, lambda: norms.rmsnorm(x, w, 1e-6))
    for T, D in s.RESIDUAL_ADD_SHAPES:
        x, r = (torch.randn(T, D, device="cuda", generator=gen).to(bf16) for _ in range(2))
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        for pos in ("pre", "post"):
            out[f"P_{T}x{D}_{pos}"] = s.graph_ms(torch, lambda: norms.residual_add_rmsnorm(x, r, w, 1e-6, pos))
    digests = {}
    for K, N in s.GEMM_SHAPES:
        for M in s.INT4_MS:
            x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
            wp = torch.randint(-128, 128, (N // 2, K), device="cuda", generator=gen, dtype=torch.int8)
            xs, ws = torch.rand(M, 1, device="cuda", generator=gen), torch.rand(N, device="cuda", generator=gen)
            run = lambda: int4_matmul.int4_scaled_matmul(x, wp, xs, ws, bf16)  # noqa: E731
            out[f"G_{M}x{K}x{N}"] = s.graph_ms(torch, run)
            digests[f"G_{M}x{K}x{N}"] = run()
    # L at the train step's activation in three dtypes (bf16 timed), and unaligned, which takes the scalar route
    for dtype, shape, offset in ((bf16, (s.TRAIN_TOKENS, 9728), 0), (torch.float16, (s.TRAIN_TOKENS, 9728), 0),
                                 (torch.float32, (s.TRAIN_TOKENS, 9728), 0), (bf16, (1001,), 1)):
        n = math.prod(shape)
        x = torch.randn(n + offset, device="cuda", generator=gen).to(dtype)[offset:].view(shape)
        dy = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        tag_l = "" if dtype == bf16 and not offset else f"_{str(dtype).split('.')[-1]}_{n}"
        for name, run in (("L_fwd", lambda: silu_vjp.silu_fwd(x)), ("L_bwd", lambda: silu_vjp.silu_bwd(x, dy))):
            if not tag_l:
                out[name] = s.graph_ms(torch, run)
            digests[name + tag_l] = run()
    digests = {k: digest(v) for k, v in digests.items()}
    saved = {}
    rope_and_quant(s, out, digests, saved)
    backward_kernels(s, out, digests, saved)
    grouped_quant(s, out, digests, saved)
    print(tag, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    print(tag, "digests", " ".join(f"{k} {v}" for k, v in digests.items()), flush=True)
    if save_dir is not None:
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in saved.items()}, Path(save_dir) / f"{tag}.pt")


def ordered_bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers in the order of the values (sign and magnitude to two's complement)."""
    width = t.element_size() * 8
    bits = t.view({16: torch.int16, 32: torch.int32}[width]).long()
    return torch.where(bits < 0, -(bits & ((1 << (width - 1)) - 1)), bits)


def ulps(save_dir: str, tag_a: str, tag_b: str) -> None:
    a, b = (torch.load(Path(save_dir) / f"{tag}.pt") for tag in (tag_a, tag_b))
    for name in a:
        x, y = a[name], b[name]
        if x.dtype == torch.int8:
            step = (x.int() - y.int()).abs()
        else:
            step = (ordered_bits(x) - ordered_bits(y)).abs()
        unit = "steps" if x.dtype == torch.int8 else "ulps"
        print(f"{tag_a} vs {tag_b} {name}: {int((step > 0).sum())} of {x.numel()} differ, at most "
              f"{int(step.max())} {unit}", flush=True)


def host(s, card: str, tag: str) -> None:
    import time

    from mojo_opset_tpu_torch.backends.cuda import build
    from mojo_opset_tpu_torch.backends.cuda.kernels import int4_matmul, mla_decode

    gen = torch.Generator(device="cuda").manual_seed(1)
    out, sms, n = {}, build.sm_count(torch.device("cuda")), 2000
    for K, N in s.GEMM_SHAPES:
        x = torch.randint(-128, 128, (1, K), device="cuda", generator=gen, dtype=torch.int8)
        wp = torch.randint(-128, 128, (N // 2, K), device="cuda", generator=gen, dtype=torch.int8)
        xs, ws = torch.rand(1, 1, device="cuda", generator=gen), torch.rand(N, device="cuda", generator=gen)
        for _ in range(50):
            int4_matmul.int4_scaled_matmul(x, wp, xs, ws, torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            int4_matmul.int4_scaled_matmul(x, wp, xs, ws, torch.bfloat16)
        torch.cuda.synchronize()
        out[f"G_call_us_1x{K}x{N}"] = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for _ in range(n):
            int4_matmul.route(1, N, K, sms)
        out[f"G_route_us_1x{K}x{N}"] = (time.perf_counter() - t0) / n * 1e6
    print(tag, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    mla(s, tag, cases=3)
    print(f"{tag}: phase 7", flush=True)
    s.phase_w4a8_speculative(torch, card)


def mla(s, tag: str, cases: int = 6) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda.kernels import mla_decode

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, r, dr, bs = torch.bfloat16, 512, 64, s.BLOCK_SIZE
    first_step = [m + 1 for m in s.PROMPT_LENS]
    rows = [(b, p + 1) for b, m in enumerate(s.PROMPT_LENS) for p in range(m)]
    out, digests = {}, {}
    for name, lens, row_pairs in (("I_decode_bs4", first_step, None), ("I_decode_bs1", first_step[:1], None),
                                  ("I_prefill_rows", list(s.PROMPT_LENS), rows), ("I_bs1_ctx4096", [4096], None),
                                  ("I_bs1_ctx32768", [32768], None), ("I_bs24_ctx4000", [4000] * 24, None))[:cases]:
        cols = max(17, -(-max(lens) // bs))
        n_blocks = max(4 * 17 + 4, sum(-(-m // bs) for m in lens) + 4)
        c = torch.randn(n_blocks, 1, bs, r, device="cuda", generator=gen).to(bf16)
        pe = torch.randn(n_blocks, 1, bs, dr, device="cuda", generator=gen).to(bf16)
        table = s._tables(torch, lens, bs, cols, n_blocks, gen)
        pairs = list(enumerate(lens)) if row_pairs is None else row_pairs
        seqs = None if row_pairs is None else torch.tensor([b for b, _ in pairs], dtype=torch.int32, device="cuda")
        limits = torch.tensor([m for _, m in pairs], dtype=torch.int32, device="cuda")
        q_lat = (torch.randn(len(pairs), 128, r, device="cuda", generator=gen) * 0.05).to(bf16)
        q_pe = (torch.randn(len(pairs), 128, dr, device="cuda", generator=gen) * 0.05).to(bf16)
        run = lambda: mla_decode.mla_decode_absorbed(q_lat, q_pe, c, pe, limits, table, seqs)  # noqa: E731
        out[name] = s.graph_ms(torch, run)
        digests[name] = run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        for kernel in ("mla_mma_kernel", "mla_merge_kernel", "mla_fma_kernel", "mla_decode_kernel"):
            ms = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and kernel in e.key) / 1e3
            if ms:
                out[f"{name}:{kernel}"] = ms
        del c, pe
        torch.cuda.empty_cache()
    print(tag, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    print(tag, "digests", " ".join(f"{k} {digest(v)}" for k, v in digests.items()), flush=True)


def dkv(s, tag: str) -> None:
    from mojo_opset_tpu_torch.backends.cuda.kernels import flash_diffusion as fd
    from mojo_opset_tpu_torch.backends.cuda.kernels import flash_swa as fs
    from mojo_opset_tpu_torch.experimental.functions import block_diffusion_mask

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f16, out = torch.bfloat16, torch.float16, {}
    for name, lens, hq, hkv, d, dtype in (("J_train_bf16", [2048, 2048], 32, 8, 128, bf16),
                                          ("J_train_fp16", [2048, 2048], 32, 8, 128, f16),
                                          ("J_group65_fp16", [200, 3], 130, 2, 64, f16)):
        cu = s._cu(torch, lens)
        q, do = (torch.randn(sum(lens), hq, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(sum(lens), hkv, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        o, lse = fs.flash_swa_fwd_plain(q, k, v, cu, cu)
        _, delta = fs.flash_swa_dq_plain(q, k, v, o, do, lse, cu, cu)
        want = fs.flash_swa_dkv_plain(q, k, v, do, lse, delta, cu, cu)
        run = lambda: fs.flash_swa_dkv(q, k, v, do, lse, delta, cu, cu)  # noqa: E731
        out[f"{name}_ms"] = s.graph_ms(torch, run)
        out[f"{name}_rel_dk"], out[f"{name}_rel_dv"] = (s.rel_errors(g, w)[0] for g, w in zip(run(), want))
    mask = block_diffusion_mask(s.DIFFUSION_S, s.DIFFUSION_BLOCK, device="cuda")
    for name, dtype in (("O_function_bf16", bf16), ("O_function_fp16", f16)):
        shape = (s.DIFFUSION_B, s.DIFFUSION_H, s.DIFFUSION_S, s.DIFFUSION_D)
        q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
        o, lse = fd.flash_diffusion_fwd_plain(q, k, v, mask)
        _, delta = fd.flash_diffusion_dq_plain(q, k, v, o, do, lse, mask)
        want = fd.flash_diffusion_dkv_plain(q, k, v, do, lse, delta, mask)
        run = lambda: fd.flash_diffusion_dkv(q, k, v, do, lse, delta, mask)  # noqa: E731
        out[f"{name}_ms"] = s.graph_ms(torch, run)
        out[f"{name}_rel_dk"], out[f"{name}_rel_dv"] = (s.rel_errors(g, w)[0] for g, w in zip(run(), want))
    print(tag, " ".join(f"{k} {v:.6g}" for k, v in out.items()), flush=True)


def train(s, card: str, tag: str) -> None:
    """Phases 10 and 15 as chip_smoke.py runs them, recording the train steps' times, the kernel path's profiled
    step and the conv Function's timed calls on the way."""
    steps, profiles, conv_ms = [], [], []
    step_fn, profile_fn, cuda_ms = s._train_step, s._step_profile, s.cuda_ms

    def record_step(*args, **kwargs):
        result = step_fn(*args, **kwargs)
        if not profiles:  # the kernel path's steps come before its profiled step
            steps.append(result[1:])
        return result

    def record_profile(torch_, prof):
        from torch.autograd import DeviceType

        result = profile_fn(torch_, prof)
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        split = {n: sum(e.self_device_time_total for e in device if n in e.key) / 1e3
                 for n in ("rmsnorm_bwd_", "mojo_column_sum_kernel")}
        profiles.append((*result[:2], split))
        return result

    def record_ms(*args, **kwargs):
        result = cuda_ms(*args, **kwargs)
        conv_ms.append(result)
        return result

    s._train_step, s._step_profile = record_step, record_profile
    try:
        s.phase_train_full_width(torch, card)
    finally:
        s._train_step, s._step_profile = step_fn, profile_fn
    s.cuda_ms = record_ms
    try:
        s.phase_conv_function(torch, card)
    finally:
        s.cuda_ms = cuda_ms
    timed = steps[-(s.TRAIN_STEPS + 1):-1]  # the 5 timed steps, before the profiled one
    parts = [float(np.mean([t[i] for t in timed])) for i in range(3)]
    busy, fam_ms, split = profiles[0]
    # phase 15 times the cuda tier, then the ref tier, in each of its two forms
    print(f"{tag} train step_ms {sum(parts):.2f} fwd_ms {parts[0]:.2f} bwd_ms {parts[1]:.2f} adamw_ms "
          f"{parts[2]:.2f} busy_ms {busy:.3f} K_ms {fam_ms['K']:.4f} K_row_kernels_ms {split['rmsnorm_bwd_']:.4f} "
          f"column_sum_ms {split['mojo_column_sum_kernel']:.4f} conv_fwd_bwd_ms_state {conv_ms[0]:.4f} "
          f"conv_fwd_bwd_ms_residual {conv_ms[2]:.4f} ({card})", flush=True)


def paths(s, card: str, tag: str) -> None:
    print(f"{tag}: phases 5, 6, 7 and 11", flush=True)
    s.phase_full_width(torch, card)
    s.phase_int8_full_width(torch, card)
    s.phase_w4a8_speculative(torch, card)
    s.phase_seed_oss_full_width(torch, card)


def main() -> int:
    if sys.argv[1:2] == ["ulps"] and len(sys.argv) == 5:
        ulps(*sys.argv[2:])
        return 0
    s = load_chip_smoke()
    card = s.phase_device(torch)
    s.phase_build()
    if sys.argv[1:2] == ["readings"]:
        readings(s)
    elif sys.argv[1:2] == ["times"] and len(sys.argv) in (3, 4):
        times(s, *sys.argv[2:])
    elif sys.argv[1:2] == ["host"] and len(sys.argv) == 3:
        host(s, card, sys.argv[2])
    elif sys.argv[1:2] == ["mla"] and len(sys.argv) == 3:
        mla(s, sys.argv[2])
    elif sys.argv[1:2] == ["dkv"] and len(sys.argv) == 3:
        dkv(s, sys.argv[2])
    elif sys.argv[1:2] == ["paths"] and len(sys.argv) == 3:
        paths(s, card, sys.argv[2])
    elif sys.argv[1:2] == ["train"] and len(sys.argv) == 3:
        train(s, card, sys.argv[2])
    else:
        raise SystemExit("usage: kernel_ab.py readings | times TAG [DIR] | ulps DIR TAG_A TAG_B | host TAG | mla TAG | "
                         "dkv TAG | paths TAG | train TAG")
    return 0


if __name__ == "__main__":
    sys.exit(main())
