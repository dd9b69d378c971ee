#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mojo_opset_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
     TF32 off for fp32 matmuls and convolutions.
  2. build: compiles the four kernels from ``mojo_opset_tpu_torch/csrc``.
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes in bf16 and on edge cases, within the dtype's
     tolerance (utils/acc.py ladder); both timed with CUDA events.
  4. small fp32 Qwen3 (4 layers, hidden 512, 8/2 heads, head_dim 128,
     vocab 4096): greedy tokens of the kernel path equal the plain path's
     (MOJO_BACKEND=ref) over 16 steps.
  5. the slice at full width: Qwen3-4B geometry (bench.py:89-103) in bf16
     with random weights, block size 64, NHD: paged prefill of 4 requests
     (1000, 513, 130, 7 tokens), 32 greedy decode steps through
     MojoGenerator, one FusedDecode window. Launch counters are zeroed
     just before and read just after; every kernel must have launched.
     Last-token prefill logits agree with the plain path (per-row cosine
     >= 0.999: bf16 rounds at other places in the fp32 online softmax than
     in the gathered softmax).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
}


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
    from mojo_opset_tpu_torch.backends.cuda.kernels import norms, paged_decode, paged_prefill, rope
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    record = {}

    def compare(name, kernel_fn, plain_fn, dtype, case, main=False):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        check_tol_diff(got, want, **tols_for(dtype))
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        line = f"{case} {str(dtype).split('.')[-1]}: max_abs_err {err:.3g} (tol {tols_for(dtype)})"
        if main:
            ms, plain_ms = cuda_ms(torch, kernel_fn), cuda_ms(torch, plain_fn, iters=5)
            record[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
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

    # C: decode at the main path's lengths after prefill + decode (main), edge cases
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

    # D: prefill of the main path's batch (main); chunked, empty, short, ABAB, HND, D 64/256
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
    return record


def _build_pair(torch, config):
    """The kernel-path model (default tier) and a plain-path twin
    (MOJO_BACKEND=ref) with the same weights."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM

    model = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    os.environ["MOJO_BACKEND"] = "ref"
    try:
        plain = Qwen3ForCausalLM(config, device="cuda")
    finally:
        del os.environ["MOJO_BACKEND"]
    plain.load_state_dict(model.state_dict())
    attn = model.model.layers[0].self_attn
    assert type(attn.attn_decode).__name__ == "CudaPagedDecodeGQA", type(attn.attn_decode)
    assert type(plain.model.layers[0].self_attn.attn_decode).__name__ == "RefPagedDecodeGQA"
    return model, plain


def _prompts(vocab: int, lens) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    return rng.integers(1, vocab, int(sum(lens))).astype(np.int32), np.asarray(lens, np.int32)


def phase_small_model(torch) -> None:
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    config = Qwen3Config(**SMALL, dtype=torch.float32)
    model, plain = _build_pair(torch, config)
    ids, lens = _prompts(config.vocab_size, (37, 20, 5, 64))
    tokens = {}
    for name, m in (("kernel", model), ("plain", plain)):
        gen = MojoGenerator(PagedAttentionGenerationModel(m, block_size=16), None, GreedySampler(), max_new_tokens=16)
        tokens[name] = gen.generate_from_ids(ids, lens, ignore_eos=True)
    fused = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16), None, GreedySampler(),
                          max_new_tokens=16).generate_from_ids(ids, lens, ignore_eos=True, fused_decode=True)
    log("small fp32 model", f"kernel tokens {tokens['kernel'].tolist()}")
    if not np.array_equal(tokens["kernel"], tokens["plain"]):
        raise AssertionError(f"greedy tokens differ: kernel {tokens['kernel'].tolist()} plain {tokens['plain'].tolist()}")
    if not np.array_equal(tokens["kernel"], fused):
        raise AssertionError(f"fused tokens differ from stepwise: {fused.tolist()}")
    log("small fp32 model", "16 greedy steps: kernel path == plain path == fused window")
    del model, plain
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
    counts = kernels.launch_counts()
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


def main() -> int:
    import torch

    card = phase_device(torch)
    phase_build()
    record = phase_kernels(torch)
    phase_small_model(torch)
    counts = phase_full_width(torch, card)
    kernels_line = [
        dict(name=name, route="cuda", source=source, replaces=replaces, launches=counts[module],
             **record[module])
        for module, (name, source, replaces) in KERNEL_INFO.items()
    ]
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
