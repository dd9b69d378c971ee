#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mojo_opset_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
     TF32 off for fp32 matmuls and convolutions.
  2. build: compiles the six kernels from ``mojo_opset_tpu_torch/csrc``
     (one nvcc per source, all at once, then one link).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes and on edge cases, both timed with CUDA events.
     Float outputs hold to the dtype's tolerance (utils/acc.py ladder);
     RMSNorm + quant (E) holds its scales to rtol 1e-6 and its int8 values
     to one step on at most 0.1% of them (a sum in another order can move
     a tie); the int8 GEMM (F) equals its plain version exactly with unit
     scales and fp32 output (the int32 sums). The decode and prefill
     kernels run on bf16/fp32/fp16 pages and on int8 (C8) pages.
  4. small fp32 Qwen3 (4 layers, hidden 512, 8/2 heads, head_dim 128,
     vocab 4096), and its w8a8 and w8a8 + C8 twins: greedy tokens of the
     kernel path equal the plain path's (MOJO_BACKEND=ref, same weights)
     over 16 steps, and the FusedDecode window's.
  5. the bf16 slice at full width: Qwen3-4B geometry (bench.py:89-103) in
     bf16 with random weights, block size 64, NHD: paged prefill of 4
     requests (1000, 513, 130, 7 tokens), 32 greedy decode steps through
     MojoGenerator, one FusedDecode window. Launch counters are zeroed
     just before and read just after; every kernel of the path must have
     launched. Last-token prefill logits agree with the plain path
     (per-row cosine >= 0.999: bf16 rounds at other places in the fp32
     online softmax than in the gathered softmax).
  6. the int8 slice at full width: the same geometry, bf16 weights from
     seed 0 quantized on the card by ``quantize_qwen3`` (w8a8) with the C8
     int8 cache (HND, block 64); the same prompts, 32 greedy steps and a
     FusedDecode window, counters as in 5; all six kernels must launch.
     Last-token logits: finite, per-row cosine >= 0.999 against the plain
     path; the cosine against the bf16 model is printed, with no bound.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

# Qwen3-4B geometry as bench.py:89-103 runs it
QWEN3_4B = dict(
    hidden_size=2560, intermediate_size=9728, num_attention_heads=32, num_key_value_heads=8,
    num_hidden_layers=36, head_dim=128, vocab_size=151936, max_position_embeddings=4416,
)
SMALL = dict(
    hidden_size=512, intermediate_size=1536, num_attention_heads=8, num_key_value_heads=2,
    num_hidden_layers=4, head_dim=128, vocab_size=4096, max_position_embeddings=256,
)
PROMPT_LENS = (1000, 513, 130, 7)
DECODE_STEPS = 32
FUSED_STEPS = 16
BLOCK_SIZE = 64

KERNEL_INFO = {
    "norms": ("rmsnorm", "mojo_opset_tpu_torch/csrc/rmsnorm.cu",
              "mojo_opset_tpu/backends/pallas/kernels/norms.py:45"),
    "rope": ("rope_token_first", "mojo_opset_tpu_torch/csrc/rope.cu",
             "mojo_opset_tpu/backends/pallas/kernels/rope.py:166"),
    "paged_decode": ("paged_decode_gqa", "mojo_opset_tpu_torch/csrc/paged_decode.cu",
                     "mojo_opset_tpu/backends/pallas/kernels/paged_decode.py:260"),
    "paged_prefill": ("paged_prefill_gqa", "mojo_opset_tpu_torch/csrc/paged_prefill.cu",
                      "mojo_opset_tpu/backends/pallas/kernels/flash_prefill.py:358"),
    "rmsnorm_quant": ("rmsnorm_quant", "mojo_opset_tpu_torch/csrc/rmsnorm_quant.cu",
                      "mojo_opset_tpu/backends/pallas/kernels/norms.py:131"),
    "int8_matmul": ("int8_scaled_matmul", "mojo_opset_tpu_torch/csrc/int8_matmul.cu",
                    "mojo_opset_tpu/backends/pallas/kernels/int8_matmul.py:54"),
}
BF16_PATH_KERNELS = ("norms", "rope", "paged_decode", "paged_prefill")
# (K, N) of the w8a8 projections at Qwen3-4B: q, k/v, o, gate/up, down; the lm_head at M = 4
GEMM_SHAPES = ((2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    from mojo_opset_tpu_torch.backends.cuda import build

    t0 = time.perf_counter()
    path = build.build()
    build.load_library()
    log("build", f"{path.name} ready in {time.perf_counter() - t0:.1f} s")


def _cache(torch, n_blocks, hkv, bs, D, layout, dtype, gen):
    shape = (n_blocks, hkv, bs, D) if layout == "HND" else (n_blocks, bs, hkv, D)
    return (torch.randn(shape, device="cuda", generator=gen).to(dtype),
            torch.randn(shape, device="cuda", generator=gen).to(dtype))


def _int8_cache(torch, n_blocks, hkv, bs, D, gen):
    """int8 HND pages and (Hkv, D) fp32 channel scales."""
    shape = (n_blocks, hkv, bs, D)
    pages = [torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(hkv, D, device="cuda", generator=gen) * 0.015 + 0.005 for _ in range(2)]
    return pages, scales


def _tables(torch, lens, bs, n_cols, n_blocks, gen):
    perm = torch.randperm(n_blocks, device="cuda", generator=gen).tolist()
    rows, used = [], 0
    for n in lens:
        need = -(-n // bs)
        rows.append(perm[used:used + need] + [-1] * (n_cols - need))
        used += need
    return torch.tensor(rows, dtype=torch.int32, device="cuda")


def _cu(torch, lens):
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device="cuda")


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version; returns the main-path record."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import (
        int8_matmul, norms, paged_decode, paged_prefill, rmsnorm_quant, rope,
    )
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    record = {}

    def compare(name, kernel_fn, plain_fn, dtype, case, main=False, key=None, check=None):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        if check is None:
            check_tol_diff(got, want, **tols_for(dtype))
            tol = tols_for(dtype)
        else:
            tol = check(got, want)
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        line = f"{case} {str(dtype).split('.')[-1]}: max_abs_err {err:.3g} (tol {tol})"
        if main:
            ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn, iters=5)
            entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            if key is None:
                record[name] = entry
            else:
                record.setdefault(name, {}).setdefault(key, entry)
            line += f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        log(f"kernel {name}", line)

    T = sum(PROMPT_LENS)
    H, Hkv, D, hidden = 32, 8, 128, 2560
    # A: RMSNorm — layer norm at the prefill batch (main), q/k head norms, odd widths
    for shape, dtype, main in (((T, hidden), bf16, True), ((T, H, D), bf16, False), ((T, Hkv, D), bf16, False),
                               ((4, hidden), bf16, False), ((5, 33), torch.float32, False),
                               ((3, 300), torch.float16, False)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        w = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5
        compare("norms", lambda: norms.rmsnorm(x, w, 1e-6), lambda: norms.rmsnorm_plain(x, w, 1e-6),
                dtype, f"rmsnorm {shape}", main)
    # B: RoPE token-first on the prefill batch's q and k (main), odd T
    for n, dtype, main in ((T, bf16, True), (7, torch.float32, False), (1, torch.float16, False)):
        q = torch.randn(n, H, D, device="cuda", generator=gen).to(dtype)
        k = torch.randn(n, Hkv, D, device="cuda", generator=gen).to(dtype)
        pos = torch.arange(n, device="cuda", dtype=torch.float32)[:, None]
        ang = pos * (1.0 / 10000 ** (torch.arange(0, D, 2, device="cuda") / D))
        cos, sin = torch.cat([ang, ang], -1).cos().to(dtype), torch.cat([ang, ang], -1).sin().to(dtype)
        compare("rope", lambda: rope.rope_token_first(q, k, cos, sin),
                lambda: rope.rope_token_first_plain(q, k, cos, sin), dtype, f"rope T={n}", main)

    # C / C': decode at the main path's lengths after prefill + decode (main), edge cases; int8 pages
    n_blocks = 4 * 69
    dec_lens = [n + DECODE_STEPS for n in PROMPT_LENS]
    cases = [(bf16, "NHD", "AABB", H, Hkv, D, dec_lens, None, True),
             (bf16, "HND", "ABAB", H, Hkv, D, [0, 1, 64, 65], None, False),
             (torch.float32, "NHD", "AABB", 8, 8, 64, [17, 0, 130], 0.3, False),
             (bf16, "NHD", "ABAB", 12, 2, 128, [700, 9, 64], None, False),
             (torch.float16, "HND", "AABB", 16, 1, 256, [200, 3], None, False)]
    for dtype, layout, gqa, hq, hkv, d, lens, scale, main in cases:
        kc, vc = _cache(torch, n_blocks, hkv, BLOCK_SIZE, d, layout, dtype, gen)
        bt = _tables(torch, lens, BLOCK_SIZE, 69, n_blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        compare("paged_decode",
                lambda: paged_decode.paged_decode_gqa(q, kc, vc, sl, bt, scale, gqa, layout),
                lambda: paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, scale, gqa, layout),
                dtype, f"decode {layout} {gqa} {hq}/{hkv}x{d} lens={lens} scale={scale}", main)
    del kc, vc
    int8_cases = [(bf16, "AABB", H, Hkv, D, dec_lens, True),
                  (bf16, "ABAB", H, Hkv, D, [0, 1, 64, 65], False),
                  (torch.float32, "AABB", 8, 8, 64, [17, 0, 130], False),
                  (torch.float16, "ABAB", 16, 2, 256, [200, 3], False)]
    for dtype, gqa, hq, hkv, d, lens, main in int8_cases:
        (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, BLOCK_SIZE, d, gen)
        bt = _tables(torch, lens, BLOCK_SIZE, 69, n_blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        compare("paged_decode",
                lambda: paged_decode.paged_decode_gqa(q, kc, vc, sl, bt, None, gqa, "HND", ks, vs),
                lambda: paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, None, gqa, "HND", ks, vs),
                dtype, f"decode int8 pages HND {gqa} {hq}/{hkv}x{d} lens={lens}", main, key="int8_pages")

    # D / D': prefill of the main path's batch (main); chunked, empty, short, ABAB, HND, D 64/256; int8 pages
    cases = [(bf16, "NHD", "AABB", H, Hkv, D, list(PROMPT_LENS), list(PROMPT_LENS), None, True),
             (bf16, "HND", "ABAB", H, Hkv, D, [5, 0, 1, 40], [69, 0, 9, 40], None, False),
             (torch.float32, "NHD", "AABB", 8, 8, 64, [3, 70, 1], [3, 130, 0], 0.3, False),
             (torch.float16, "HND", "AABB", 16, 1, 256, [33, 7], [33, 100], None, False)]
    for dtype, layout, gqa, hq, hkv, d, q_lens, kv_lens, scale, main in cases:
        kc, vc = _cache(torch, n_blocks, hkv, BLOCK_SIZE, d, layout, dtype, gen)
        bt = _tables(torch, kv_lens, BLOCK_SIZE, 69, n_blocks, gen)
        cu_q, cu_kv = _cu(torch, q_lens), _cu(torch, kv_lens)
        q = torch.randn(sum(q_lens), hq, d, device="cuda", generator=gen).to(dtype)
        compare("paged_prefill",
                lambda: paged_prefill.paged_prefill_gqa(q, kc, vc, cu_q, bt, scale, cu_kv, gqa, layout,
                                                        max_q_len=max(q_lens)),
                lambda: paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, bt, scale, cu_kv, gqa, layout),
                dtype, f"prefill {layout} {gqa} {hq}/{hkv}x{d} q={q_lens} kv={kv_lens} scale={scale}", main)
    del kc, vc
    int8_cases = [(bf16, "AABB", H, Hkv, D, list(PROMPT_LENS), list(PROMPT_LENS), True),
                  (bf16, "ABAB", H, Hkv, D, [5, 0, 1, 40], [69, 0, 9, 40], False),
                  (torch.float32, "AABB", 8, 8, 64, [3, 70, 1], [3, 130, 0], False),
                  (torch.float16, "AABB", 16, 1, 256, [33, 7], [33, 100], False)]
    for dtype, gqa, hq, hkv, d, q_lens, kv_lens, main in int8_cases:
        (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, BLOCK_SIZE, d, gen)
        bt = _tables(torch, kv_lens, BLOCK_SIZE, 69, n_blocks, gen)
        cu_q, cu_kv = _cu(torch, q_lens), _cu(torch, kv_lens)
        q = torch.randn(sum(q_lens), hq, d, device="cuda", generator=gen).to(dtype)
        compare("paged_prefill",
                lambda: paged_prefill.paged_prefill_gqa(q, kc, vc, cu_q, bt, None, cu_kv, gqa, "HND",
                                                        max_q_len=max(q_lens), key_scale=ks, value_scale=vs),
                lambda: paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, bt, None, cu_kv, gqa, "HND",
                                                              key_scale=ks, value_scale=vs),
                dtype, f"prefill int8 pages HND {gqa} {hq}/{hkv}x{d} q={q_lens} kv={kv_lens}", main,
                key="int8_pages")
    del kc, vc

    # E: RMSNorm + int8 quant — the layer norms at the prefill batch (main) and a decode batch, odd
    # widths in f32/f16, a zero row, a smooth scale
    def check_quant(got, want):
        (q_k, s_k), (q_p, s_p) = got, want
        check_tol_diff(s_k, s_p, atol=0.0, rtol=1e-6)
        diff = (q_k.int() - q_p.int()).abs()
        moved = int((diff > 0).sum())
        if diff.max().item() > 1 or moved > 1e-3 * diff.numel():
            raise AssertionError(f"rmsnorm_quant: {moved} int8 values moved, max step {diff.max().item()}")
        return f"scale rtol 1e-6, q +-1 on {moved}/{diff.numel()} <= 0.1%"

    for shape, dtype, zero_row, smooth, main in (((T, hidden), bf16, False, False, True),
                                                 ((8, hidden), bf16, True, False, False),
                                                 ((5, 33), torch.float32, False, True, False),
                                                 ((3, 300), torch.float16, True, True, False),
                                                 ((6, 2560), torch.float32, False, True, False)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        if zero_row:
            x[1] = 0
        w = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5
        sm = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5 if smooth else None
        compare("rmsnorm_quant", lambda: rmsnorm_quant.rmsnorm_quant(x, w, 1e-6, sm),
                lambda: rmsnorm_quant.rmsnorm_quant_plain(x, w, 1e-6, sm), dtype,
                f"rmsnorm_quant {shape} zero_row={zero_row} smooth={smooth}", main, check=check_quant)

    # F: int8 GEMM at every w8a8 projection shape (prefill M = T, decode M = 8), the lm_head at M = 4,
    # a (K, N) weight at ragged M, three output dtypes; unit scales + fp32 output must be exact
    def exact(got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"int8 GEMM int32 sums differ: max {(got - want).abs().max().item()}")
        return "exact"

    def gemm_case(M, K, N, trans, dtype, unit, main, key=None):
        w = torch.randint(-127, 128, (N, K) if trans else (K, N), device="cuda", generator=gen, dtype=torch.int8)
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        xs = torch.ones(M, 1, device="cuda") if unit else torch.rand(M, 1, device="cuda", generator=gen) * 0.1
        ws = torch.ones(N, device="cuda") if unit else torch.rand(N, device="cuda", generator=gen) * 1e-3
        compare("int8_matmul", lambda: int8_matmul.int8_scaled_matmul(x, w, xs, ws, trans, dtype),
                lambda: int8_matmul.int8_scaled_matmul_plain(x, w, xs, ws, trans, dtype), dtype,
                f"int8 gemm M={M} K={K} N={N} trans={trans} unit_scales={unit}", main, key=key,
                check=exact if unit else None)

    for K, N in GEMM_SHAPES:
        for M in (T, 8):
            gemm_case(M, K, N, True, bf16, False, True, key=f"{M}x{K}x{N}")
            gemm_case(M, K, N, True, torch.float32, True, False)
    gemm_case(4, hidden, 151936, True, bf16, False, True, key=f"4x{hidden}x151936")
    for M in (1, 7, 130):
        for dtype in (bf16, torch.float16, torch.float32):
            gemm_case(M, 272, 400, False, dtype, False, False)
        gemm_case(M, 272, 400, False, torch.float32, True, False)
    return record


def _build_pair(torch, config):
    """The kernel-path model (default tier) and a plain-path twin
    (MOJO_BACKEND=ref) with the same weights."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM

    model = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    with plain_tier():
        plain = Qwen3ForCausalLM(config, device="cuda")
    plain.load_state_dict(model.state_dict())
    attn = model.model.layers[0].self_attn
    assert type(attn.attn_decode).__name__.startswith("Cuda"), type(attn.attn_decode)
    assert type(plain.model.layers[0].self_attn.attn_decode).__name__.startswith("Ref")
    return model, plain


@contextlib.contextmanager
def plain_tier():
    """Ops constructed inside take the golden tier (MOJO_BACKEND=ref)."""
    os.environ["MOJO_BACKEND"] = "ref"
    try:
        yield
    finally:
        del os.environ["MOJO_BACKEND"]


def _quantized_pair(torch, source, quant_kv: bool):
    """w8a8 twins of ``source`` on the kernel path and on the plain path:
    the same int8 weights, quantized on the card."""
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize_qwen3

    model = quantize_qwen3(source, quant_kv=quant_kv)
    with plain_tier():
        plain = quantize_qwen3(source, quant_kv=quant_kv)
    layer = model.model.layers[0]
    assert type(layer.input_layernorm).__name__ == "CudaRMSNormQuant", type(layer.input_layernorm)
    assert type(layer.mlp.down_proj).__name__ == "CudaQuantGemm"
    assert type(plain.model.layers[0].mlp.down_proj).__name__ == "RefQuantGemm"
    for a, b in zip(model.state_dict().values(), plain.state_dict().values()):
        assert torch.equal(a, b)
    return model, plain


def _prompts(vocab: int, lens) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    return rng.integers(1, vocab, int(sum(lens))).astype(np.int32), np.asarray(lens, np.int32)


def _greedy_match(torch, name, model, plain, ids, lens) -> None:
    """16 greedy steps: kernel path == plain path == fused window."""
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    def generate(m, fused=False):
        gen = MojoGenerator(PagedAttentionGenerationModel(m, block_size=16), None, GreedySampler(), max_new_tokens=16)
        return gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused)

    tokens, plain_tokens, fused = generate(model), generate(plain), generate(model, fused=True)
    log(name, f"kernel tokens {tokens.tolist()}")
    if not np.array_equal(tokens, plain_tokens):
        raise AssertionError(f"{name}: greedy tokens differ: kernel {tokens.tolist()} plain {plain_tokens.tolist()}")
    if not np.array_equal(tokens, fused):
        raise AssertionError(f"{name}: fused tokens differ from stepwise: {fused.tolist()}")
    log(name, "16 greedy steps: kernel path == plain path == fused window")


def phase_small_model(torch) -> None:
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config

    ids, lens = _prompts(SMALL["vocab_size"], (37, 20, 5, 64))
    model, plain = _build_pair(torch, Qwen3Config(**SMALL, dtype=torch.float32))
    _greedy_match(torch, "small fp32 model", model, plain, ids, lens)
    for quant_kv, name in ((False, "small w8a8 model"), (True, "small w8a8 + C8 model")):
        q_model, q_plain = _quantized_pair(torch, model, quant_kv)
        _greedy_match(torch, name, q_model, q_plain, ids, lens)
    del model, plain, q_model, q_plain
    torch.cuda.empty_cache()


def phase_full_width(torch, card: str) -> dict:
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config
    from mojo_opset_tpu_torch.runtime import (
        FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook,
    )

    config = Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16, kv_layout="NHD")
    t0 = time.perf_counter()
    model, plain = _build_pair(torch, config)
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    log("full width", f"Qwen3-4B geometry, {n_params / 1e9:.2f} B params bf16, built in "
                      f"{time.perf_counter() - t0:.1f} s")
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1, hooks=[hook])

    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up: allocator, cuBLAS handles
    kernels.reset_launch_counts()
    out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    logits, session = gm(ids, context_input_len=lens)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_fused = time.perf_counter()
    window = FusedDecode(model)(session, first, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t_fused) * 1e3 / FUSED_STEPS
    counts = {k: v for k, v in kernels.launch_counts().items() if k in BF16_PATH_KERNELS}
    log("full width", f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {counts}")

    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    window = window.T.cpu().numpy()
    if not np.array_equal(window, out[:, 1:FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {window.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    plain_logits, _ = PagedAttentionGenerationModel(plain, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    cos = torch.nn.functional.cosine_similarity(logits, plain_logits, dim=-1)
    log("full width", f"last-token logits {tuple(logits.shape)} finite; per-row cosine vs plain path "
                      f"{[round(c, 6) for c in cos.tolist()]} (bound 0.999)")
    if cos.min().item() < 0.999:
        raise AssertionError(f"prefill logits disagree with the plain path: cosine {cos.tolist()}")

    rec = hook.records[-1]
    log("full width", f"{card}: prefill {rec['prefill_ms']:.2f} ms ({rec['in_tok']} tokens, bs 4); "
                      f"decode {rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise, "
                      f"{rec['decode_steps']} steps); FusedDecode {fused_ms:.3f} ms/step, "
                      f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log("full width", f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    return counts


def phase_int8_full_width(torch, card: str) -> dict:
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import (
        FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    source = Qwen3ForCausalLM(Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
    ids, lens = _prompts(QWEN3_4B["vocab_size"], PROMPT_LENS)
    bf16_logits, _ = PagedAttentionGenerationModel(source, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    model, plain = _quantized_pair(torch, source, quant_kv=True)
    del source  # its projections go; the embedding and norms stay, shared with the twins
    torch.cuda.empty_cache()
    n_int8 = sum(p.numel() for p in model.parameters() if p.dtype == torch.int8)
    log("int8 full width", f"Qwen3-4B geometry w8a8 + C8: {n_int8 / 1e9:.3f} B int8 weights, quantized on the "
                           f"card in {time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
                           f"GiB held by the kernel-path and plain-path twins")
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1, hooks=[hook])

    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up
    kernels.reset_launch_counts()
    out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    logits, session = gm(ids, context_input_len=lens)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_fused = time.perf_counter()
    window = FusedDecode(model)(session, first, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t_fused) * 1e3 / FUSED_STEPS
    counts = kernels.launch_counts()
    log("int8 full width", f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the int8 path never launched: {counts}")
    key0 = session.caches.key(0)
    if key0.dtype != torch.int8 or session.kv_layout != "HND" or not bool((session.caches.key_scale(0) > 0).all()):
        raise AssertionError(f"the session's cache is not calibrated int8 HND: {key0.dtype} {session.kv_layout}")

    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    window = window.T.cpu().numpy()
    if not np.array_equal(window, out[:, 1:FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {window.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    plain_logits, _ = PagedAttentionGenerationModel(plain, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    cos = torch.nn.functional.cosine_similarity(logits, plain_logits, dim=-1)
    cos_bf16 = torch.nn.functional.cosine_similarity(logits, bf16_logits, dim=-1)
    log("int8 full width", f"last-token logits {tuple(logits.shape)} finite; per-row cosine vs plain path "
                           f"{[round(c, 6) for c in cos.tolist()]} (bound 0.999); vs the bf16 model "
                           f"{[round(c, 4) for c in cos_bf16.tolist()]} (no bound: random weights)")
    if cos.min().item() < 0.999:
        raise AssertionError(f"int8 prefill logits disagree with the plain path: cosine {cos.tolist()}")

    rec = hook.records[-1]
    log("int8 full width", f"{card}: prefill {rec['prefill_ms']:.2f} ms ({rec['in_tok']} tokens, bs 4); "
                           f"decode {rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise, "
                           f"{rec['decode_steps']} steps); FusedDecode {fused_ms:.3f} ms/step, "
                           f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak memory "
                           f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log("int8 full width", f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    return counts


def kernels_line(record: dict, counts: dict, bf16_counts: dict) -> list:
    """One entry per kernel: launches from the int8 full-width run (it runs
    all six), times of the main-path case; C and D add their int8-page
    times, F its time at each shape."""
    line = []
    gemm_main = f"{sum(PROMPT_LENS)}x2560x9728"
    for module, (name, source, replaces) in KERNEL_INFO.items():
        rec = dict(record[module])
        extra = {}
        if module == "int8_matmul":
            extra["by_shape"] = rec
            rec = rec[gemm_main]
            extra["main_shape"] = gemm_main
        elif "int8_pages" in rec:
            extra["int8_pages"] = rec.pop("int8_pages")
        if module in bf16_counts:
            extra["launches_bf16_path"] = bf16_counts[module]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=counts[module],
                         max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"], **extra))
    return line


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    record = phase_kernels(torch)
    phase_small_model(torch)
    bf16_counts = phase_full_width(torch, card)
    counts = phase_int8_full_width(torch, card)
    print(json.dumps({"kernels": kernels_line(record, counts, bf16_counts)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
