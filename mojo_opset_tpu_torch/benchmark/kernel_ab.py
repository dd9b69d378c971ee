"""Kernels D (paged prefill), H (grouped GEMM), F (int8 GEMM), A (RMSNorm), P (residual add + RMSNorm), G
(packed-int4 GEMM) and L (SiLU) of one tree, for comparing two trees on one card.

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
  at (1650, 2560), 4096 x 4096 and 8192 x 8192, bf16.
- ``paths TAG``: this tree's phases 6 (Qwen3-4B w8a8 + C8) and 11
  (Seed-OSS-36B cut to 32 layers, bf16 and w8a8) on the tree's kernels,
  each printing its prefill and decode times and one profiled prefill
  (device busy ms, D's and F's shares).

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


def times(s, tag: str) -> None:
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
    print(tag, " ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    print(tag, "digests", " ".join(f"{k} {hashlib.sha256(v.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]}"
                                   for k, v in digests.items()), flush=True)


def paths(s, card: str, tag: str) -> None:
    print(f"{tag}: phases 6, 7 and 11", flush=True)
    s.phase_int8_full_width(torch, card)
    s.phase_w4a8_speculative(torch, card)
    s.phase_seed_oss_full_width(torch, card)


def main() -> int:
    s = load_chip_smoke()
    card = s.phase_device(torch)
    s.phase_build()
    if sys.argv[1:2] == ["readings"]:
        readings(s)
    elif sys.argv[1:2] == ["times"] and len(sys.argv) == 3:
        times(s, sys.argv[2])
    elif sys.argv[1:2] == ["paths"] and len(sys.argv) == 3:
        paths(s, card, sys.argv[2])
    else:
        raise SystemExit("usage: kernel_ab.py readings | times TAG | paths TAG")
    return 0


if __name__ == "__main__":
    sys.exit(main())
