#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mojo_opset_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code
is non-zero:
  1. device: needs CUDA; prints the card's name and power limit (nvidia-smi);
     TF32 off for fp32 matmuls and convolutions.
  2. build: compiles the eighteen kernels' sources (seventeen files: A and P
     share ``rmsnorm.cu``) from ``mojo_opset_tpu_torch/csrc`` (one nvcc per
     source, all at once, then one link).
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main-path shapes and on edge cases, both timed with CUDA events.
     Float outputs hold to the dtype's tolerance (utils/acc.py ladder);
     RMSNorm (A) also runs at the q/k head norms (T x 32 and T x 8 rows of
     128), DeepSeek-V3's, Seed-OSS-36B's and the Wan DiT's widths, and odd
     ones, the head norms and the DiT's (4400, 3072) timed beside
     F.rms_norm, every case repeated bit for bit;
     RMSNorm + quant (E) holds its scales to rtol 1e-6 and its int8 values
     to one step on at most 0.1% of them (a sum in another order can move
     a tie), at the prefill batch, decode rows (T 1, 4, 8 with a zero row)
     and Seed-OSS-36B's width on its register route (timed) and on its
     generic kernel (fp32 at 5120, odd widths), every case repeated bit for
     bit; token-first RoPE (B) at the prefill batch and decode rows (T 1
     and 4) at Qwen3-4B's and Seed-OSS-36B's heads and DeepSeek-V3's rope
     lanes on its vector route (timed), and on its generic route (D 96, an
     unaligned view, whose outputs equal the vector route's bit for bit),
     every case repeated bit for bit; the int8 GEMM (F) and the packed-int4 GEMM (G) equal their
     plain versions exactly with unit scales and fp32 output (the int32
     sums). F runs at Qwen3-4B's and Seed-OSS-36B's projections at M = T
     (its wgmma route, timed beside torch._int_mm) and M = 8 (its decode
     route, K split where the output tiles leave SMs idle), the lm_head at
     M = 4, ragged M, N and K on the wgmma route, the decode route split
     and a (K, N) weight in three output dtypes, every case repeated bit
     for bit. G runs at the
     w4a8 projection shapes with M = 1, 5 and 512 (its decode and its wgmma
     routes), ragged M, K split over the wgmma
     units, every case repeated bit for bit, and refuses N % 128 != 0; its
     main cases are also timed beside F on the unpacked int8 weight (a
     reference, not a library call). Main cases are timed
     replayed from a CUDA graph (device time, not the host's launch rate).
     The decode and prefill kernels run on bf16/fp32/fp16 pages and on int8
     (C8) pages; decode (C, C') also at groups 20 (40/2, a partial 16-head
     chunk) and 32 (32/1), and at Qwen3-4B's geometry at bs 1, 8 and 24 at
     ctx 4000 (the first benchmark's decode grid) beside SDPA over the
     gathered pages; every C and C' case repeats bit for bit over two runs
     (its split-KV merge runs in a fixed order). Prefill (D, D') also runs
     at block sizes 16 and 32 (below its 64-key tile), D 64/128/256,
     Seed-OSS-36B's group 10 and group 64, each output held relative to its
     size to PAGED_PREFILL_REL_LIMITS (whole tensor, worst (token, head)
     row) and every bf16/fp16 case repeated bit for bit. The grouped GEMM (H)
     runs at the MoE path's shapes (prefill
     and decode at bs 4 and 1, fc1 and down, routed top-8 of 128) and on
     empty and 1-row groups, ragged M, K and N, rows past the groups' end,
     both weight layouts and three dtypes, and refuses K % 8 != 0 in bf16;
     at G = 256 with prefill tiles that straddle groups, and at DeepSeek-V3's
     expert shapes; each output held relative to its size to
     GROUP_GEMM_REL_LIMITS (whole, worst row) and every bf16/fp16 case on
     its prefill tile repeated bit for bit. The int8 / packed-int4 grouped
     GEMM (R) runs at the quantized MoE paths' shapes (Qwen3-30B-A3B's fc1
     and down, G 128, int8 and int4, DeepSeek-V3's, G 256, int8; decode at
     bs 4 from one top-8 routing and the prefill batch's 13200 rows), then
     groups of 0, 1, 15, 16, 17 and 129 rows, an empty tail, every tile and
     every output dtype, and refuses K % 16 != 0; every case equals the
     plain version bit for bit and repeats bit for bit, each main case
     timed beside H's bf16 time on the same shapes (a reference: no
     PyTorch call computes an int8 grouped product). The absorbed MLA kernel
     (I) runs at DeepSeek-V3's widths: decode at bs 4 and 1, prefill's row
     mode over the prompt batch, decode at bs 1 over ctx 4096 and 32768 and
     at bs 24 over ctx 4000, and edge cases (a zero-length sequence, -1
     table padding, contexts off the block size, one page, H 4 and 16, a
     sink, fp16 decode and prefill, fp32, r 256, r 1024 on one ring stage,
     r 16 / dr 8), its fp32 output to the fp32 ladder, every case repeated
     bit for bit (its split merge runs in a fixed order), each main case
     timed beside SDPA as MQA over the gathered latent; A and B also
     run at DeepSeek's widths. Shapes the port once refused and JAX
     computes run through their ops against the golden op: C and C' at
     head_dim 96 (C in fp32 at 80), D and D' at 96, D at group 71/1, J at
     71/1 and at head_dim 96 and O at 96 (forward and backward), each
     launching its kernel; F and G at K 40 and H at K 36 take the golden
     (golden_calls + 1, no launch). The same head_dims (96 and 80) and
     groups over 64 also run among C's, D's, J's and O's own cases against
     their plain versions, held as those kernels' other cases are (the
     relative limits included), in bf16, fp16 and fp32; C and D, which run
     them at a wider width in shared memory, store nothing past their
     columns (a guard after the output stays untouched), and J's and O's
     padding is inert (their outputs equal the first columns of a run on
     inputs padded by hand, the other columns exactly 0). Kernel J's three entry points (forward, dq,
     dk/dv) run at the training shape (B 2 x S 2048, 32/8 heads, D 128,
     causal), varlen with both windows and a local one, suffix-q, a
     zero-length sequence and fully masked rows (their o, dq, dk, dv exactly
     0), MHA, group 4 under ABAB, groups 8 and 7 (ABAB, a ragged 63-row
     tile), D 64 and 256, fp16 and fp32, with lse and delta to the fp32
     ladder, dq, dk and dv bit for bit over two runs; and the Wan DiT's
     maskless L = 1560 SDPA and its clip's L = 4400 (24 heads, timed beside
     SDPA) through CudaSdpa. Each of J's outputs is also held, relative to
     its own size, to FLASH_SWA_REL_LIMITS (the whole tensor and its worst
     row).
     Kernel C with the TPU kernel's windows: ctx 32768 at B 4 with local
     1024 and global 64, bf16 and int8 pages, timed beside the same cases
     without windows (the windowed case must take under half the time:
     pages outside the window are skipped, not masked), and local only,
     global only, a window longer than the context, seq_len 0, both layouts
     and GQA orders, fp16 and fp32.
     The training kernels at the step's shapes in bf16, fp16 and fp32 at
     one shape, and edge cases: K (RMSNorm backward) at (4096, 2560),
     (131072, 128) and (32768, 128) on its register route, also at (4097,
     2560), (13, 2560), (1, 128) and (5, 5120), and on its generic kernels
     (odd widths, unaligned views, (4096, 2560) unaligned), its dx and dw also
     bit for bit over two runs, the timed cases with their kernel's registers
     and blocks an SM; L (SiLU forward and backward) at (4096, 9728); M (RoPE over a
     strided head-first view, forward and backward) on q (2, 32, 2048, 128)
     and k (2, 8, 2048, 128) head-first, token-first as a transposed view
     and as (T, H, D) rows; each output to its ladder and, relative to its
     size, to TRAIN_KERNEL_REL_LIMITS. Kernel N (fused linear + CE: stats, dz,
     dx, dw) at the train step's lm_head (N 4096, H 2560, V 151936, bf16),
     then fp16, fp32, every option of JAX's test matrix, ragged N and V,
     every row ignored, one row and the chunked-dz backward (4 runs); each
     output to its ladder and, relative to its size, to FLCE_REL_LIMITS;
     dz, dx, dw bit for bit over two runs; the main cases beside the cuBLAS
     time of the same product, with each product's TFLOP/s printed. Kernel O (masked attention: forward, dq,
     dk/dv) at the diffusion Function's shape (B 2 x 16 heads x S 4096, D
     128, block-diffusion mask of 64) in bf16, fp16 and fp32 (S 2048),
     SDAR-30B-A3B's GQA (32/4 heads, S 2048), a random mask with empty rows,
     a full (B, H, Sq, Sk) mask with Sq != Sk whose empty rows give NaN
     (CudaSdpa's semantics), odd S 1000 at D 64 and 256, and the Wan DiT's
     key-padding mask (B 2, 24 heads, S 4400, lens 4400 and 880); each
     output to its ladder and, relative to its size, to
     FLASH_DIFFUSION_REL_LIMITS; empty rows' o exactly 0 (or NaN) and dq 0,
     unkept keys' dk and dv 0; dq, dk, dv bit for bit over two runs; the
     main cases beside SDPA with the bool mask and its eager backward.
     Kernel P (residual add + RMSNorm, pre and post) at Qwen3-4B's prefill
     rows and the JAX perf shapes 4096 x 4096 and 8192 x 8192 in bf16, then
     fp16, fp32, an fp32 residual beside bf16 rows, odd T and D, T = 1 and a
     misaligned view; kernel Q (causal conv1d forward and backward) at the
     conv Function's benchmark shape (B 8, T 8192, D 2048, W 4, SiLU, bf16,
     fp32 weight and bias) and T 2048, W 2 and 3 at T 8192 (its exact-width
     kernels), JAX's test matrix (W 1, 3, 4, 8, a chunk shorter than the
     window, odd T, no bias, a state), fp16 (also T 257 with a state), D not
     a multiple of 128, W 16 (the generic kernels) and a misaligned view,
     refusing W 17; each output to its ladder and, relative to its size, to
     SLICE_E_REL_LIMITS; Q's dx, dw, db bit for bit over two runs; the timed
     cases with their kernels' registers and blocks an SM.
     Every main case is timed replayed from a CUDA graph (``ms``: device
     time; ``eager_ms`` is the host-paced loop), beside its bound (bytes over
     3.35 TB/s or operations over the dtype's peak, the larger) and, where
     one PyTorch call computes the same function, that call's time (C: SDPA
     over the pages gathered beforehand; D: SDPA over the padded prompt rows
     with a causal + padding mask; P: the add and F.rms_norm, two calls; Q:
     depthwise F.conv1d with bias, no SiLU, and its autograd backward).
  4. small fp32 Qwen3 (4 layers, hidden 512, 8/2 heads, head_dim 128,
     vocab 4096), a small fp32 Seed-OSS of the same widths (q/k/v biases),
     a small fp32 Qwen3-MoE of the same widths (16 experts,
     top-4, expert width 256) with its w8a8 and w4a8 twins (kernel R), a
     small w8a8 DeepSeek-V3 (SMALL_DEEPSEEK: one dense and one MoE layer),
     and the dense model's w8a8, w8a8 + C8 and w4a8 twins: greedy tokens of
     the kernel path equal the plain path's (MOJO_BACKEND=ref, same
     weights) over 16 steps, and the FusedDecode window's. The w4a8 twins',
     the quantized MoE twins' and the DeepSeek twin's paths may part once
     at a near-tie: there the two paths' logits differ by <= 0.05 and the
     plain path's top-2 gap is below that difference (an int8 activation
     crossed a rounding tie). The w8a8 MoE twin's continuous batcher (4
     requests on 2 slots) gives each request its standalone greedy tokens.
     Then, exactly:
     SpeculativeDecoder (k = 4) ``generate`` and ``generate_fused`` with
     the w4a8 draft and with a 1-layer truncated draft equal vanilla greedy
     of the fp32 model; ContinuousBatchingGenerator (6 requests on 2 slots,
     prefix cache on, 4 prompts behind one 128-token prefix) and
     SpeculativeContinuousBatchingGenerator (w4a8 draft) give every request
     its standalone greedy tokens.
  5. the bf16 slice at full width: Qwen3-4B geometry (bench.py:89-103) in
     bf16 with random weights, block size 64, NHD: paged prefill of 4
     requests (1000, 513, 130, 7 tokens), 32 greedy decode steps through
     MojoGenerator, one FusedDecode window. Launch counters are zeroed
     just before and read just after; every kernel of the path must have
     launched. Last-token prefill logits agree with the plain path
     (per-row cosine >= 0.999: bf16 rounds at other places in the fp32
     online softmax than in the gathered softmax). One more prefill runs
     under torch.profiler: its device busy ms and kernel D's share (phases
     6, 8, 9 and 11 print the same, with H's and I's shares).
  6. the int8 slice at full width: the same geometry, bf16 weights from
     seed 0 quantized on the card by ``quantize_qwen3`` (w8a8) with the C8
     int8 cache (HND, block 64); the same prompts, 32 greedy steps and a
     FusedDecode window, counters as in 5; all six kernels must launch.
     Last-token logits: finite, per-row cosine >= 0.999 against the plain
     path; the cosine against the bf16 model is printed, with no bound.
  7. w4a8 speculative decoding at full width (bench.py:298-331): a bf16
     Qwen3-4B target from seed 0, its w4a8 twin quantized on the card as
     the draft, bs 1, a 512-token prompt, 64 new tokens, k = 4, block 64.
     The draft's last-token logits hold per-row cosine >= 0.999 against its
     plain path. Counters as in 5 over vanilla greedy (stepwise and
     FusedDecode) and speculative ``generate_fused`` and ``generate``; all
     seven kernels must launch; G's launches are also logged by route and
     M, and must add up to its count; one prefill of the draft alone is
     profiled (device busy ms, G's share). Each speculative stream equals vanilla
     greedy, or first leaves it where the target's two best logits lie
     within 0.05 (the verify runs kernel D, vanilla kernel C: bf16 rounds
     differently). Prints vanilla and speculative ms/token, rounds, the
     acceptance, the int4 weight bytes and peak memory.
  8. Qwen3-MoE at full width: Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B,
     config.json: hidden 2048, 48 layers, 32/4 heads, head_dim 128, 128
     experts, top-8, expert width 768, vocab 151936, rope_theta 1e6) in
     bf16 with random weights from seed 0, NHD, block 64; the plain twin is
     built on the meta device and bound to the kernel model's tensors. The
     prompts, 32 greedy steps and FusedDecode window of phase 5; all five
     path kernels must launch, group_gemm 96 times per decode step; the
     FusedDecode window runs with host syncs turned into errors from the
     model's first call on. On one layer, fed the prefill batch's hidden
     states, the cuda experts equal the plain experts under the same routing
     (bf16 ladder); end to end, the share of top-8 routes the two paths agree
     on and the per-row cosine of the last-token logits (bound
     MOE_COSINE_BOUND: routes flip at near-ties, see PERF.md). Prints the
     readings, peak memory and one decode step's device time from
     torch.profiler. Then the w8a8 and w4a8 halves: the plain twin goes,
     and the model turns into both quantized twins one layer at a time
     (``quantize_qwen3_moe_layer``), each bf16 layer freed once both hold it
     (the peak stays near the bf16 model's, and is printed); each twin runs
     phase 5's run against its plain twin on its tensors (its path kernels,
     R among them, must launch; the FusedDecode window with host syncs as
     errors; the decode step's R, F and G shares; logits per-row cosine
     against the plain twin >= MOE_INT8_COSINE_BOUND / MOE_INT4_COSINE_BOUND,
     against the bf16 model printed), and one layer's quantized experts
     equal the plain experts bit for bit under one routing, for the prefill
     batch and the last tokens.
  9. DeepSeek-V3 at full width (DEEPSEEK_V3: hidden 7168, 128 heads, q LoRA
     1536, kv LoRA 512, rope 64, 256 experts top-8 of width 2048, a shared
     expert, vocab 129280), depth cut 61 -> 5 (its 3 dense layers and 2 MoE
     layers) and positions to 1088, bf16, random weights from seed 0,
     block 64; the plain twin (meta device, bound to the same tensors) runs
     the golden ops except the two paged MLA ops, which run kernel I's plain
     version. The prompts, steps and FusedDecode window of phase 5 (the
     window with host syncs as errors); norms, rope, mla_decode and
     group_gemm must launch, mla_decode 5 and group_gemm 4 times a decode
     step, the GQA attention kernels never. One layer's MLA decode equals
     the golden decompressing op on its cache (DEEPSEEK_LAYER_TOL); end to end,
     the top-8 route agreement and the per-row logit cosine (bound
     DEEPSEEK_COSINE_BOUND). Prints the readings, peak memory and one
     decode step's device time from torch.profiler. Then the w8a8 half:
     the model turns into its w8a8 twin one layer at a time
     (``quantize_deepseek_v3_layer``), each bf16 layer freed as it goes, and
     runs the same checks on its path (E, F and R in place of H, R 4 times
     a decode step), its logits held to its plain twin
     (DEEPSEEK_INT8_COSINE_BOUND) and printed against the bf16 model's.
 10. Qwen3 training at Qwen3-4B geometry in bf16 (random weights from seed
     0, one repeated batch of B 2 x S 2048 random ids): a twin check at
     depth 2, one step on the training path's kernels (A and K under the
     norms, L under the SiLU, M under RoPE, J under attention, N under the
     loss) and one with
     each kernel's plain version in its place (the same model), the loss to
     TRAIN_LOSS_REL_BOUND and every parameter's gradient to
     TRAIN_GRAD_COSINE_BOUND (the loss's kernel N is swapped too); then at
     depth 36, train_forward + the loss through the dispatched
     MojoFusedLinearCrossEntropyFunction (kernel N) + backward + fused
     AdamW: a warm-up step and TRAIN_STEPS counted steps (per step A and K
     145 launches, L 36 forward and 36 backward, M 72, J once forward and
     twice backward a layer, N's four entry points once; CudaSdpa's and
     the loss's golden routes are never taken; the loss is finite and
     falls), then one profiled step; the same steps with the chunked golden
     loss (its peak memory must not be below kernel N's), and with golden
     norms, RoPE and SiLU, for comparison. Prints step, forward and
     backward ms, tokens/s, mfu, peak memory, the device idle share, the
     device time of J, A, K, L, M and N, and each loss tier's step ms, loss
     ms and peak memory.
 11. Seed-OSS at Seed-OSS-36B widths (SEED_OSS_36B: hidden 5120, 80/8
     heads, q/k/v biases, vocab 155136), depth cut 64 -> 32, bf16, random
     weights from seed 0, block 64, a plain twin on the same tensors; phase
     5's prompts, steps and FusedDecode window on A-D (logit cosine >= 0.999
     against the plain path), then its w8a8 twin from quantize_seed_oss
     (biases in bf16 beside the int8 GEMMs) on A-F under phase 6's gates.
     Prints prefill ms, decode ms/step, one decode step's launches and
     device time, and peak memory.
 12. the Wan2.2-TI2V-5B DiT (WAN_TI2V_5B: dim 3072, ffn 14336, 24 heads of
     128, 30 layers, in/out 48, patch (1, 2, 2), text 512 x 4096) at full
     width and depth in bf16, random weights from seed 0, a plain twin
     (golden SDPA and RMSNorm) on the same tensors; first a small fp32 DiT
     (WAN_SMALL) against its twin within the fp32 ladder. Latents of a
     17-frame 704 x 1280 clip (48, 5, 44, 80) = 4400 tokens (frames cut 121
     -> 17), 64 random text rows a request: (a) 4 Euler steps of the clip
     alone (self- and cross-attention on J, q/k norms on A), (b) 2 steps of
     the clip beside a one-frame image (48, 1, 44, 80) padded to 4400 tokens
     (self-attention on O under the key-padding mask, 30 launches a step).
     Velocity cosine >= WAN_COSINE_BOUND against the twin at the first step
     and on the final latents, (b)'s clip against (a)'s; launches exact;
     CudaSdpa never takes the golden. Prints ms/step, TFLOP/s and mfu
     (dit_step_flops at 512 context keys), the device idle share and J's,
     O's and A's device time from one profiled step, and peak memory.
 13. MojoDiffusionAttentionFunction forward + backward at the Function's
     shape and at SDAR's GQA, bf16: the cuda tier (O's three entry points
     once a call) against the ref tier's autograd of the golden, o, dq, dk,
     dv relative to their size (DIFFUSION_GOLDEN_REL_LIMITS); fwd + bwd ms
     and peak memory of each tier.
 14. MojoResidualAddRMSNorm built through dispatch (CudaResidualAddRMSNorm,
     kernel P) against the ref tier on the same tensors at (1650, 2560),
     4096 x 4096 and 8192 x 8192 in bf16, pre and post: P launches once a
     call and nothing else; both outputs to the bf16 ladder and relative to
     their size (RESIDUAL_ADD_GOLDEN_REL_LIMITS), cosine printed; ms per call on P
     and on the golden.
 15. MojoCausalConv1dFunction forward + backward at the conv Function's
     benchmark shape, the cuda tier (kernel Q) against the ref tier's
     autograd of the golden, with an initial state and output_final_state,
     and with a residual: out, the final state, dx, dw, db, dstate and
     dresidual relative to their size (CONV_GOLDEN_REL_LIMITS); Q's
     forward and backward once a call; fwd + bwd ms and peak memory of each
     tier; one cu_seqlens call takes the golden, the only one counted in
     golden_calls.
Phases 5-12 (the models, the quantized halves of 8 and 9 among them) must
leave every cuda-tier class's golden_calls where it was: a golden route on
a model path fails its phase.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
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
# Qwen3-30B-A3B (huggingface.co/Qwen/Qwen3-30B-A3B, config.json) at full width and depth; the positions
# cover the longest prompt, its 32 decode steps and one more step
QWEN3_30B_A3B = dict(
    hidden_size=2048, intermediate_size=6144, num_attention_heads=32, num_key_value_heads=4,
    num_hidden_layers=48, head_dim=128, vocab_size=151936, max_position_embeddings=1088, rope_theta=1e6,
    num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
)
SMALL_MOE = dict(SMALL, num_experts=16, num_experts_per_tok=4, moe_intermediate_size=256)
# a small DeepSeek-V3 of the same widths for its w8a8 twin: one dense and one MoE layer, MLA with q LoRA 256,
# kv LoRA 128, rope 32
SMALL_DEEPSEEK = dict(
    hidden_size=512, intermediate_size=1536, moe_intermediate_size=256, num_attention_heads=8, num_hidden_layers=2,
    vocab_size=4096, max_position_embeddings=256, q_lora_rank=256, kv_lora_rank=128, qk_rope_head_dim=32,
    qk_nope_head_dim=64, v_head_dim=64, n_routed_experts=16, n_shared_experts=1, num_experts_per_tok=4,
    first_k_dense_replace=1,
)
# DeepSeek-V3 (huggingface.co/deepseek-ai/DeepSeek-V3, config.json) at full width; the depth is cut 61 -> 5 (its 3
# dense layers and 2 MoE layers: 50 GiB of bf16 weights, a third MoE layer would not leave room on one card) and the
# positions to 1088 (the longest prompt, its decode steps and one more)
DEEPSEEK_V3 = dict(
    hidden_size=7168, intermediate_size=18432, moe_intermediate_size=2048, num_attention_heads=128,
    num_hidden_layers=5, vocab_size=129280, max_position_embeddings=1088, q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_head_dim=64, qk_nope_head_dim=128, v_head_dim=128, n_routed_experts=256, n_shared_experts=1,
    num_experts_per_tok=8, first_k_dense_replace=3,
)
DEEPSEEK_FULL = dict(num_hidden_layers=61, max_position_embeddings=4096)  # what the cuts above cut from
DEEPSEEK_LAYER_CHECKED = 4  # the layer whose MLA decode is held to the golden op on its cache
# that layer's check: the bf16 output (largest value ~0.69) parts from the golden's by the rounding of q_lat and of
# the absorbed products; the run that set it saw a max_abs_err of 0.0039, so 0.02 leaves 5x room, while a wrong
# absorption or causal limit moves values by the output's own scale (PERF.md, section 6)
DEEPSEEK_LAYER_TOL = dict(atol=0.02, rtol=0.0)
# end-to-end prefill logits against the plain twin: bf16 rounds at other places in the latent-space softmax, and
# 0.3-0.5% of the top-8 routes of the 2 MoE layers flip at near-ties (the same ones each run: weights and inputs
# come from fixed seeds); the run that set it saw 1 - cosine of 0.7e-5 to 1.4e-5 (PERF.md, section 6), so 1e-4
# leaves 7x room
DEEPSEEK_COSINE_BOUND = 0.9999
MOE_LAYER_CHECKED = 24  # the layer whose experts are held to the plain experts under the same routing
# end-to-end prefill logits against the plain path: bf16 rounding flips ~1.7% of the top-8 routes at near-ties
# over 48 layers; the run that set it saw cosines 0.99933-0.99968 (PERF.md, section 6)
MOE_COSINE_BOUND = 0.998
# the quantized halves of phases 8 and 9, end-to-end prefill logits against their plain twins (the golden tier on
# the same int8 tensors): R equals its plain version bit for bit, but the attention kernels round bf16 at other
# places, which moves int8 activations across rounding ties (in E's and the experts' dynamic quant) and flips top-8
# routes at near-ties, as in bf16. The run that set them (PERF.md, section 6) saw 1 - cosine of at most
# 7.99e-4 (Qwen3-30B-A3B w8a8), 8.07e-4 (w4a8) and 2.58e-4 (DeepSeek-V3 w8a8): each bound leaves 5x room, while a
# wrong expert, scale or nibble order moves the logits wholesale
MOE_INT8_COSINE_BOUND = 0.996
MOE_INT4_COSINE_BOUND = 0.9959
DEEPSEEK_INT8_COSINE_BOUND = 0.9987
PROMPT_LENS = (1000, 513, 130, 7)
DECODE_STEPS = 32
DECODE_GRID_BS = (1, 8, 24)  # kernel C at Qwen3-4B's geometry and ctx 4000: the first benchmark's decode batches
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
    "int4_matmul": ("int4_scaled_matmul", "mojo_opset_tpu_torch/csrc/int4_matmul.cu",
                    "mojo_opset_tpu/backends/pallas/kernels/int4_matmul.py:85"),
    "group_gemm": ("grouped_matmul", "mojo_opset_tpu_torch/csrc/group_gemm.cu",
                   "mojo_opset_tpu/backends/pallas/kernels/group_gemm.py:220"),
    "mla_decode": ("mla_decode_absorbed", "mojo_opset_tpu_torch/csrc/mla_decode.cu",
                   "mojo_opset_tpu/backends/pallas/kernels/mla_decode.py:151"),
    # kernel J's three entry points replace flash_swa's three pallas_calls
    "flash_swa_fwd": ("flash_swa_fwd", "mojo_opset_tpu_torch/csrc/flash_swa.cu",
                      "mojo_opset_tpu/backends/pallas/kernels/flash_vjp.py:337"),
    "flash_swa_dq": ("flash_swa_dq", "mojo_opset_tpu_torch/csrc/flash_swa.cu",
                     "mojo_opset_tpu/backends/pallas/kernels/flash_vjp.py:402"),
    "flash_swa_dkv": ("flash_swa_dkv", "mojo_opset_tpu_torch/csrc/flash_swa.cu",
                      "mojo_opset_tpu/backends/pallas/kernels/flash_vjp.py:436"),
    "rmsnorm_vjp": ("rmsnorm_vjp", "mojo_opset_tpu_torch/csrc/rmsnorm_vjp.cu",
                    "mojo_opset_tpu/backends/pallas/kernels/rmsnorm_vjp.py:56"),
    # kernel L's two entry points replace silu_vjp's two pallas_calls
    "silu_fwd": ("silu_vjp_fwd", "mojo_opset_tpu_torch/csrc/silu.cu",
                 "mojo_opset_tpu/backends/pallas/kernels/silu_vjp.py:52"),
    "silu_bwd": ("silu_vjp_bwd", "mojo_opset_tpu_torch/csrc/silu.cu",
                 "mojo_opset_tpu/backends/pallas/kernels/silu_vjp.py:71"),
    "rope_head_first": ("rope_head_first", "mojo_opset_tpu_torch/csrc/rope_head_first.cu",
                        "mojo_opset_tpu/backends/pallas/kernels/rope.py:97"),
    # kernel N's four entry points replace flce's three pallas_calls: the statistics (:120), and the dx (:241) and
    # dw (:266) kernels, each of which recomputes dz, which N computes once for both
    "flce_stats": ("flce_stats", "mojo_opset_tpu_torch/csrc/flce.cu",
                   "mojo_opset_tpu/backends/pallas/kernels/flce.py:120"),
    "flce_dz": ("flce_dz", "mojo_opset_tpu_torch/csrc/flce.cu", "mojo_opset_tpu/backends/pallas/kernels/flce.py:241"),
    "flce_dx": ("flce_dx", "mojo_opset_tpu_torch/csrc/flce.cu", "mojo_opset_tpu/backends/pallas/kernels/flce.py:241"),
    "flce_dw": ("flce_dw", "mojo_opset_tpu_torch/csrc/flce.cu", "mojo_opset_tpu/backends/pallas/kernels/flce.py:266"),
    # kernel O's three entry points replace flash_diffusion's three pallas_calls
    "flash_diffusion_fwd": ("flash_diffusion_fwd", "mojo_opset_tpu_torch/csrc/flash_diffusion.cu",
                            "mojo_opset_tpu/backends/pallas/kernels/diffusion_vjp.py:179"),
    "flash_diffusion_dq": ("flash_diffusion_dq", "mojo_opset_tpu_torch/csrc/flash_diffusion.cu",
                           "mojo_opset_tpu/backends/pallas/kernels/diffusion_vjp.py:227"),
    "flash_diffusion_dkv": ("flash_diffusion_dkv", "mojo_opset_tpu_torch/csrc/flash_diffusion.cu",
                            "mojo_opset_tpu/backends/pallas/kernels/diffusion_vjp.py:252"),
    "residual_add_rmsnorm": ("residual_add_rmsnorm", "mojo_opset_tpu_torch/csrc/rmsnorm.cu",
                             "mojo_opset_tpu/backends/pallas/kernels/norms.py:82"),
    # kernel Q's two entry points replace conv1d_train's two pallas_calls
    "conv1d_fwd": ("conv1d_train_fwd", "mojo_opset_tpu_torch/csrc/conv1d.cu",
                   "mojo_opset_tpu/backends/pallas/kernels/conv1d_vjp.py:149"),
    "conv1d_bwd": ("conv1d_train_bwd", "mojo_opset_tpu_torch/csrc/conv1d.cu",
                   "mojo_opset_tpu/backends/pallas/kernels/conv1d_vjp.py:188"),
    # kernel R has no Pallas counterpart: it replaces the xla tier's int8 ragged_dot of the quantized experts
    "group_quant_gemm": ("grouped_quant_matmul", "mojo_opset_tpu_torch/csrc/group_quant_gemm.cu",
                         "mojo_opset_tpu/backends/xla/operators/moe.py:51"),
}
BF16_PATH_KERNELS = ("norms", "rope", "paged_decode", "paged_prefill")
MOE_PATH_KERNELS = BF16_PATH_KERNELS + ("group_gemm",)
INT8_PATH_KERNELS = BF16_PATH_KERNELS + ("rmsnorm_quant", "int8_matmul")
SPEC_PATH_KERNELS = INT8_PATH_KERNELS + ("int4_matmul",)
DEEPSEEK_PATH_KERNELS = ("norms", "rope", "mla_decode", "group_gemm")
# the quantized MoE paths (phases 8 and 9): the experts on R; F under the int8 projections and the lm_head, E before
# them; w4a8 puts Qwen3-30B-A3B's attention projections on G
MOE_INT8_PATH_KERNELS = INT8_PATH_KERNELS + ("group_quant_gemm",)
MOE_INT4_PATH_KERNELS = MOE_INT8_PATH_KERNELS + ("int4_matmul",)
DEEPSEEK_INT8_PATH_KERNELS = ("norms", "rope", "mla_decode", "rmsnorm_quant", "int8_matmul", "group_quant_gemm")
# (K, N) of the w8a8 and w4a8 projections at Qwen3-4B: q, k/v, o, gate/up, down; the lm_head at M = 4
GEMM_SHAPES = ((2560, 4096), (2560, 1024), (4096, 2560), (2560, 9728), (9728, 2560))
# (K, N) of the w8a8 projections at Seed-OSS-36B's widths (SEED_OSS_36B below): q, k/v, o, gate/up, down
SEED_OSS_GEMM_SHAPES = ((5120, 10240), (5120, 1024), (10240, 5120), (5120, 27648), (27648, 5120))
# the w4a8 draft's decode (M = 1), a verify-sized batch and its prompt's prefill (bench.py:307)
INT4_MS = (1, 5, 512)
INT4_MAIN_SHAPE = f"1x{GEMM_SHAPES[3][0]}x{GEMM_SHAPES[3][1]}"  # the draft's gate/up at decode
# (name, M, K, N) of the expert GEMMs at Qwen3-30B-A3B: the prefill batch routed top-8 of 128, decode at bs 4, 1
GMM_SHAPES = (("prefill_fc1", sum(PROMPT_LENS) * 8, 2048, 1536), ("prefill_down", sum(PROMPT_LENS) * 8, 768, 2048),
              ("decode_bs4_fc1", 32, 2048, 1536), ("decode_bs4_down", 32, 768, 2048),
              ("decode_bs1_fc1", 8, 2048, 1536), ("decode_bs1_down", 8, 768, 2048))
GMM_MAIN_SHAPE = "decode_bs4_fc1"
# the H100 SXM's published rates: HBM bytes/s and dense peaks by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12}
# the bs-1 speculative run of bench.py:298-331: prompt, new tokens, drafts per round
SPEC_PROMPT, SPEC_NEW, SPEC_K = 512, 64, 4
SPEC_TIE_GAP = 0.05  # a stream may leave vanilla greedy only where the target's two best logits are this close
# phase 10: AdamW steps of Qwen3 at Qwen3-4B geometry on one repeated batch of B x S tokens
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 5
TRAIN_LAYERS = 36  # the depth of the timed steps
TRAIN_TWIN_LAYERS = 2  # the depth cut of the twin check against J's plain forward and backward
TRAIN_LR = 3e-4  # 1e-3 overshot: the loss went 12.1, 6.3, 11.3, 8.5 over the first steps
TRAIN_LOSS_CHUNK = 1024  # rows of each chunk of the golden loss: (1024, 151936) fp32 logits at a time
# the twin check's per-parameter gradient cosine (kernel J vs its plain version, the rest shared): bf16 rounds o,
# dq, dk and dv at other places; the run that set it saw 1 - cosine <= 1.6e-5 over the 25 parameters (PERF.md,
# section 6), so 1e-4 leaves 6x room, while a wrong mask or GQA reduction moves a layer's gradients wholesale
TRAIN_GRAD_COSINE_BOUND = 0.9999
# the twin check's loss, as |loss - plain loss| / plain loss: the run that set it read 12.093158 against 12.093153
# (a gap of at most 8e-7 at the printed digits), so 1e-5 leaves >= 12x room
TRAIN_LOSS_REL_BOUND = 1e-5
# the small quantized twins' kernel and plain paths differ by 0.014-0.027 in logits of scale ~2 (an int8
# activation moved across a rounding tie by a sum in another order); their tokens may part only at a
# near-tie within this bound
SMALL_TIE_BOUND = 0.05
# kernel J against its plain version, each output relative to its own size: (whole tensor, worst row) limits on
# ||got - want|| / ||want||, a row being one (token, head) or (key, kv head) row of D. Both versions sum in fp32 and
# round once to the output type, so they part by one ulp at a few elements. The run that set them read at most
# 2.0e-4 / 2.0e-3 in bf16, 1.4e-5 / 3.3e-4 in fp16 and 3.0e-7 / 3.8e-4 in fp32 (PERF.md, section 6): each limit
# leaves 5-7x. A 16-key tile's PV product dropped for the last 148 rows of a sequence of 2048 reads 6.5e-3 / 0.43
# in o (the bf16 ladder passes it). ||want|| has a floor of FLASH_SWA_REL_FLOOR an element (the inputs are unit
# normal): a row that sees one key has o = v and ds = dp - delta = 0 up to fp32 rounding, and such noise is held
# absolutely
FLASH_SWA_REL_LIMITS = {"bf16": (1e-3, 1e-2), "fp16": (1e-4, 2e-3), "fp32": (2e-6, 2e-3)}
FLASH_SWA_REL_FLOOR = 1e-3
# kernel D against its plain version, relative to its size as J's are (whole tensor, worst (token, head) row; floor
# FLASH_SWA_REL_FLOOR). The plain version rounds the normalized probabilities to the query's dtype before the PV
# product, so in bf16 and fp16 it parts from any fp32-P kernel by that rounding. The scalar kernel (before its
# tensor-core route) read at most 2.54e-3 / 4.98e-3 in bf16, 3.15e-4 / 6.37e-4 in fp16 and 6.67e-7 / 2.67e-6 in
# fp32 over phase 3's D and D' cases (PERF.md, section 6, PR 13): each limit leaves 5-7x
PAGED_PREFILL_REL_LIMITS = {"bf16": (1.5e-2, 3e-2), "fp16": (2e-3, 4e-3), "fp32": (4e-6, 1.6e-5)}
# kernel H against its plain version, the same way (worst row of N). Both sum in fp32 and round once. The kernel
# before its wgmma prefill tile read at most 1.99e-4 / 1.03e-3 in bf16, 3.39e-5 / 2.37e-4 in fp16 and 8.02e-7 /
# 9.84e-7 in fp32 over phase 3's H cases (PERF.md, section 6, PR 13): each limit leaves 6x
GROUP_GEMM_REL_LIMITS = {"bf16": (1.2e-3, 6e-3), "fp16": (2e-4, 1.4e-3), "fp32": (5e-6, 6e-6)}
# CudaSdpa (J's forward) against the golden SDPA, (whole, worst row) as above: the golden rounds its probabilities to
# bf16 before the PV product; the run that set it read 2.55e-3 / 4.38e-3 at the Wan DiT's shape, so these leave 5x
SDPA_GOLDEN_REL_LIMITS = (1.25e-2, 2.2e-2)
# kernels K, L and M against their plain versions, each output relative to its own size as J's are (whole tensor,
# worst row of the last dim; floor FLASH_SWA_REL_FLOOR): both versions compute in fp32 and round once, so they part
# by an ulp at a few elements, and K's fp32 dw by its sums' order. The run that set them read at most 1.67e-5 /
# 1.41e-3 in bf16 (K's dx), 6.0e-6 / 7.6e-5 in fp16 and 4.1e-7 / 4.1e-7 in fp32 (K's dw) (PERF.md, section 6): each
# limit leaves 6-8x
TRAIN_KERNEL_REL_LIMITS = {"bf16": (1e-4, 1e-2), "fp16": (5e-5, 5e-4), "fp32": (3e-6, 3e-6)}
# kernel N against its plain version, each output relative to its own size (whole tensor, worst row of the last dim;
# rows that are 0 in the plain version, the ignored rows of dz, held to exactly 0): both versions sum in fp32 (the
# products' order differs) and round once. The run that set them read at most 9.4e-4 / 1.7e-3 in bf16 (dx at the
# step's shape; the chunked backward's dw), 2.8e-5 / 1.1e-4 in fp16 and 1.1e-5 / 1.1e-5 in fp32 (the one-row
# case's target logit; the statistics of every case are fp32) (PERF.md, section 6): each limit leaves 5-7x
FLCE_REL_LIMITS = {"bf16": (5e-3, 1e-2), "fp16": (2e-4, 8e-4), "fp32": (6e-5, 6e-5)}
# JAX's option matrix for its flce test (tests/accuracy/functions/test_flce_pallas.py:37-44)
FLCE_CONFIGS = (dict(reduction="sum"), dict(label_smoothing=0.1), dict(lse_square_scale=1e-3), dict(softcap=5.0),
                dict(label_smoothing=0.05, lse_square_scale=1e-3, softcap=8.0, reduction="sum"))
# the training step's shapes: B x S tokens, Qwen3-4B's hidden and MLP widths, 32/8 heads of 128
TRAIN_TOKENS = 2 * 2048
# Seed-OSS-36B (huggingface.co/ByteDance-Seed/Seed-OSS-36B-Instruct, config.json) at full width: q/k/v biases, no
# o or MLP bias, an untied lm_head. The depth is cut 64 -> 32 (18.9 B params, 35 GiB in bf16; ~52 GiB with the w8a8
# twin beside it) and the positions 524288 -> 1088 (the KV pool: the longest prompt, its decode steps and one more)
SEED_OSS_36B = dict(
    hidden_size=5120, intermediate_size=27648, num_attention_heads=80, num_key_value_heads=8, num_hidden_layers=32,
    head_dim=128, vocab_size=155136, max_position_embeddings=1088, rope_theta=1e7, attention_bias=True,
    attention_out_bias=False, mlp_bias=False, tie_word_embeddings=False,
)
SEED_OSS_FULL = dict(num_hidden_layers=64, max_position_embeddings=524288)  # what the cuts above cut from
# kernel O: the diffusion Function's benchmark shape in the JAX package (tools/bench_training_functions.py:198-203:
# B 2, 16 heads, S 4096, D 128 under block_diffusion_mask(4096, 64)), and SDAR-30B-A3B's attention geometry
# (huggingface.co/JetLM/SDAR-30B-A3B-Chat, config.json: 32 query heads over 4 kv heads of 128; a block-diffusion LM)
DIFFUSION_B, DIFFUSION_H, DIFFUSION_S, DIFFUSION_D, DIFFUSION_BLOCK = 2, 16, 4096, 128, 64
SDAR_HQ, SDAR_HKV, SDAR_S = 32, 4, 2048
# kernel O against its plain version, each output relative to its own size as J's are (whole tensor, worst row;
# floor FLASH_SWA_REL_FLOOR): both versions sum in fp32 and round once. The run that set them read at most 1.22e-4 /
# 2.23e-3 in bf16 (SDAR's dk/dv; the Function shape's o), 2.78e-5 / 3.09e-4 in fp16 and 6.3e-7 / 1.84e-6 in fp32
# (PERF.md, section 6): each limit leaves 6-8x
FLASH_DIFFUSION_REL_LIMITS = {"bf16": (8e-4, 1.5e-2), "fp16": (2e-4, 2e-3), "fp32": (4e-6, 1.2e-5)}
# phase 13: the cuda tier of MojoDiffusionAttentionFunction against the ref tier's autograd of the golden (which
# rounds its probabilities to bf16 before the PV product, and its backward goes through them), (whole, worst row):
# the run that set it read at most 3.19e-3 / 4.6e-3 (SDAR's dk and dv; PERF.md, section 6), so these leave 6-7x
DIFFUSION_GOLDEN_REL_LIMITS = (2e-2, 3e-2)
# phase 12: Wan2.2-TI2V-5B (huggingface.co/Wan-AI/Wan2.2-TI2V-5B, config.json; the Wan2.2 repo's
# wan/configs/wan_ti2v_5B.py) at full width and depth, bf16 parameters as the JAX package's run_dit_perf casts them
WAN_TI2V_5B = dict(model_type="ti2v", patch_size=(1, 2, 2), text_len=512, in_dim=48, dim=3072, ffn_dim=14336,
                   freq_dim=256, text_dim=4096, out_dim=48, num_heads=24, num_layers=30, qk_norm=True,
                   cross_attn_norm=True, eps=1e-6)
# latents of a 704 x 1280 clip after Wan2.2's VAE (4x in time, 16x in space, 48 channels): 17 frames -> 5, a
# one-frame image -> 1; (1, 2, 2) patches give 4400 and 880 tokens. The frames are cut 121 -> 17 (27280 -> 4400
# tokens): the full clip's self-attention alone would take ~13 s a step on J's and O's scalar FMAs
WAN_CLIP, WAN_IMAGE, WAN_FULL_FRAMES = (48, 5, 44, 80), (48, 1, 44, 80), 121
WAN_TEXT_ROWS = 64  # random text-embedding rows of each request; the model pads them to text_len
WAN_UNIFORM_STEPS, WAN_RAGGED_STEPS = 4, 2
WAN_COSINE_BOUND = 0.999
# the small fp32 twin check of phase 12: 2 layers, 2 heads of 128
WAN_SMALL = dict(model_type="ti2v", patch_size=(1, 2, 2), text_len=32, in_dim=16, dim=256, ffn_dim=512, freq_dim=64,
                 text_dim=128, out_dim=16, num_heads=2, num_layers=2)
# kernel P: the JAX package's perf shapes for the residual-add norm (tests/perf_new/operators/normalization.py:8-14,
# :45-57: T x D of 4096 x 4096 and 8192 x 8192 in bf16) and Qwen3-4B's prefill rows, beside kernel A's
RESIDUAL_ADD_SHAPES = ((sum(PROMPT_LENS), 2560), (4096, 4096), (8192, 8192))
# kernel Q: the conv Function's benchmark shape (tools/bench_training_functions.py:146-150: B 8, T 8192, D 2048,
# W 4, SiLU, bf16 rows with an fp32 weight and bias) and the perf descriptor's (tests/perf_new/functions/
# convolution.py:13: T 2048)
CONV_B, CONV_T, CONV_D, CONV_W = 8, 8192, 2048, 4
CONV_PERF_T = 2048
# kernels P and Q against their plain versions, each output relative to its own size as K's, L's and M's are (whole
# tensor, worst row of the last dim; floor FLASH_SWA_REL_FLOOR): both versions compute in fp32 and round once, so
# they part by an ulp at a few elements, and Q's fp32 dw and db by their sums' order. The run that set them read at
# most 2.23e-5 / 1.03e-3 in bf16 (Q's forward at W 16; its forward at the benchmark shape), 6.9e-6 / 7.3e-5 in fp16
# (Q's forward) and 3.6e-7 / 3.6e-7 in fp32 (Q's dw and db) (PERF.md, section 6): each limit leaves 5.6-7x
SLICE_E_REL_LIMITS = {"bf16": (1.5e-4, 6e-3), "fp16": (4e-5, 5e-4), "fp32": (2e-6, 2.5e-6)}
# phase 14: CudaResidualAddRMSNorm (P) against the golden on the same tensors, each output relative to its own size
# (whole, worst row): the golden rounds the sum to bf16 before the norm, P keeps it in fp32. The run that set them
# read 2.8e-3 / 3.15e-3 at every shape, so these leave 6x
RESIDUAL_ADD_GOLDEN_REL_LIMITS = (1.7e-2, 2e-2)
# phase 15: the cuda tier of MojoCausalConv1dFunction (Q) against the ref tier's autograd of the golden (F.conv1d in
# fp32, no TF32), as above: both compute in fp32 and round once to bf16 where the output is bf16. The run that set
# them read at most 1.5e-5 / 5.6e-4 (out), so these leave 6-7x
CONV_GOLDEN_REL_LIMITS = (1e-4, 3.5e-3)


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


def graph_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch rate does not pace the loop."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
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


def _dense_pages(torch, cache, table, lens, layout):
    """The pages of each sequence gathered into (B, Hkv, max(lens), D), zero-padded past its length's page."""
    S = max(lens)
    cols = -(-S // BLOCK_SIZE)
    pages = cache[table[:, :cols].clamp(min=0).long()]  # (B, cols, bs, Hkv, D) NHD, (B, cols, Hkv, bs, D) HND
    if layout == "HND":
        pages = pages.transpose(2, 3)
    B, _, bs, hkv, d = pages.shape
    return pages.reshape(B, cols * bs, hkv, d)[:, :S].transpose(1, 2).contiguous()


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take: the bytes over HBM's rate or the
    operations over the dtype's peak, whichever is larger (ms, which)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kind(torch, dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32", torch.int8: "int8"}[dtype]


def make_compare(torch, record: dict):
    """``compare(name, kernel_fn, plain_fn, dtype, case, ...)``: one kernel case against its plain version; a main
    case is also timed and lands in ``record[name]`` (or ``record[name][key]``)."""
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    def compare(name, kernel_fn, plain_fn, dtype, case, main=False, key=None, check=None, bound=None, library=None,
                library_graph=True, note=None):
        """``bound``: (bytes, operations, operand kind) of the main case;
        ``library``: one PyTorch call computing the same function, or None,
        replayed from a CUDA graph, or with ``library_graph=False`` timed in
        an eager loop (an autograd backward); ``note``: appended to a main
        case's log line."""
        t0 = time.perf_counter()
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
            t1 = time.perf_counter()
            b_ms, b_by = bound_ms(*bound)
            entry = dict(max_abs_err=err, ms=graph_ms(torch, kernel_fn), eager_ms=cuda_ms(torch, kernel_fn),
                         plain_ms=cuda_ms(torch, plain_fn, iters=5), bound_ms=b_ms, bound_by=b_by,
                         library_ms=None if library is None else (graph_ms if library_graph else cuda_ms)(
                             torch, library))
            lib = "none" if library is None else f"{entry['library_ms']:.4f} ms"
            line += (f"; kernel {entry['ms']:.4f} ms in a CUDA graph ({entry['eager_ms']:.4f} eager), plain "
                     f"{entry['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library {lib}; checked in "
                     f"{t1 - t0:.1f} s, timed in {time.perf_counter() - t1:.1f} s")
            if note:
                line += f"; {note}"
            if key is None:
                record[name] = entry
            else:
                record.setdefault(name, {}).setdefault(key, entry)
        log(f"kernel {name}", line)

    return compare


def phase_kernels(torch) -> dict:
    """Each kernel against its plain version; returns the main-path record."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import (
        group_gemm, int4_matmul, int8_matmul, norms, paged_decode, paged_prefill, rmsnorm_quant, rope,
    )
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    record = {}
    compare = make_compare(torch, record)

    T = sum(PROMPT_LENS)
    H, Hkv, D, hidden = 32, 8, 128, 2560
    # A: RMSNorm — layer norm at the prefill batch (main), q/k head norms (timed), the Wan DiT's layer and q/k norms
    # (timed), odd widths; every case repeats bit for bit
    for shape, dtype, key in (((T, hidden), bf16, f"{T}x{hidden}"), ((T, H, D), bf16, f"{T * H}x{D}"),
                              ((T, Hkv, D), bf16, f"{T * Hkv}x{D}"), ((4, hidden), bf16, None),
                              ((5, 33), torch.float32, None), ((3, 300), torch.float16, None),
                              ((7, D), torch.float32, None), ((9, hidden), torch.float16, None),
                              # DeepSeek-V3's norms: kv_a (512), q_a (1536) and the layer norms (7168)
                              ((T, 512), bf16, None), ((T, 1536), bf16, None), ((T, 7168), bf16, None),
                              ((4, 7168), bf16, None),
                              # Seed-OSS-36B's layer norms (5120); the Wan DiT clip's norms (WAN_TI2V_5B: 3072)
                              ((T, 5120), bf16, None), ((4400, WAN_TI2V_5B["dim"]), bf16, "4400x3072")):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        w = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5
        w_lib = w.to(dtype)
        n = x.numel()
        run = lambda: norms.rmsnorm(x, w, 1e-6)  # noqa: E731
        label = f"rmsnorm {shape} layout {norms.row_layout(shape[-1], dtype)}"
        compare("norms", run, lambda: norms.rmsnorm_plain(x, w, 1e-6), dtype, label, key is not None, key=key,
                bound=(2 * n * x.element_size() + 4 * shape[-1], 4 * n, "fp32"),
                library=lambda: torch.nn.functional.rms_norm(x, (shape[-1],), w_lib, 1e-6))
        _repeats(torch, label, run)
    log("kernel norms", "every A case repeats bit for bit over two runs")
    # B: RoPE token-first on the prefill batch's q and k (main) and at Seed-OSS-36B's 80/8 heads; decode rows (T 4
    # and 1) at Qwen3-4B's 32/8 and T 4 at Seed-OSS-36B's 80/8; DeepSeek-V3's rope lanes, q (T, 128, 64) with one
    # shared k head (all timed, on the vector route); odd T in fp32 and fp16; the generic route at D 96 and on an
    # unaligned view, whose outputs equal the vector route's on the same values bit for bit. Every case repeats bit
    # for bit
    f16, f32 = torch.float16, torch.float32
    for n, hq, hk, d, dtype, key, offset in ((T, H, Hkv, D, bf16, "main", 0), (T, 80, 8, D, bf16, f"t{T}_80x8", 0),
                                             (4, H, Hkv, D, bf16, "t4_32x8", 0), (1, H, Hkv, D, bf16, "t1_32x8", 0),
                                             (4, 80, 8, D, bf16, "t4_80x8", 0),
                                             (4, 128, 1, 64, bf16, "t4_128x1_d64", 0),
                                             (T, 128, 1, 64, bf16, None, 0), (7, H, Hkv, D, f32, None, 0),
                                             (1, H, Hkv, D, f16, None, 0), (3, 8, 2, 64, f32, None, 0),
                                             (5, 4, 2, 96, bf16, None, 0), (3, H, Hkv, D, bf16, None, 1)):
        q = torch.randn(n * hq * d + offset, device="cuda", generator=gen).to(dtype)[offset:].view(n, hq, d)
        k = torch.randn(n, hk, d, device="cuda", generator=gen).to(dtype)
        pos = torch.arange(n, device="cuda", dtype=torch.float32)[:, None]
        ang = pos * (1.0 / 10000 ** (torch.arange(0, d, 2, device="cuda") / d))
        cos, sin = torch.cat([ang, ang], -1).cos().to(dtype), torch.cat([ang, ang], -1).sin().to(dtype)
        elems = n * (hq + hk) * d
        run = lambda: rope.rope_token_first(q, k, cos, sin)  # noqa: E731
        label = f"rope T={n} q {hq}x{d} k {hk}x{d} {rope.route(q, k, cos, sin)}{' (unaligned q)' if offset else ''}"
        compare("rope", run, lambda: rope.rope_token_first_plain(q, k, cos, sin), dtype, label, key is not None,
                key=None if key == "main" else key,
                bound=((2 * elems + 2 * n * d) * q.element_size(), 3 * elems, "fp32"))
        for i in range(2):
            _repeats(torch, f"{label} output {i}", lambda i=i: run()[i])
        if rope.route(q, k, cos, sin) == "generic" and d in rope.VECTOR_WIDTHS:
            q_aligned = q.clone()
            assert rope.route(q_aligned, k, cos, sin) == "vector"
            if not all(map(torch.equal, run(), rope.rope_token_first(q_aligned, k, cos, sin))):
                raise AssertionError(f"{label}: the generic route's outputs differ from the vector route's")
    log("kernel rope", "every B case repeats bit for bit; the generic route equals the vector route bit for bit")

    _decode_cases(torch, compare, gen, record)
    _decode_window_cases(torch, compare, gen, record)
    _prefill_cases(torch, compare, gen, record)

    # E: RMSNorm + int8 quant, each case held by check_quant:
    def check_quant(got, want):
        (q_k, s_k), (q_p, s_p) = got, want
        check_tol_diff(s_k, s_p, atol=0.0, rtol=1e-6)
        diff = (q_k.int() - q_p.int()).abs()
        moved = int((diff > 0).sum())
        if diff.max().item() > 1 or moved > 1e-3 * diff.numel():
            raise AssertionError(f"rmsnorm_quant: {moved} int8 values moved, max step {diff.max().item()}")
        return f"scale rtol 1e-6, q +-1 on {moved}/{diff.numel()} <= 0.1%"

    # the layer norms at the prefill batch (main), decode rows (T 4, 1, 8 with a zero row) and Seed-OSS-36B's width
    # (all timed, on the register route); a smooth scale on both routes, odd widths in fp32 and fp16, fp32 at 5120
    # (generic). Every case repeats bit for bit
    for shape, dtype, zero_row, smooth, key in (((T, hidden), bf16, False, False, "main"),
                                                ((4, hidden), bf16, False, False, f"4x{hidden}"),
                                                ((1, hidden), bf16, False, False, f"1x{hidden}"),
                                                ((8, hidden), bf16, True, False, f"8x{hidden}"),
                                                ((4, 5120), bf16, False, False, "4x5120"),
                                                ((T, 5120), bf16, False, False, f"{T}x5120"),
                                                ((9, hidden), bf16, True, True, None),
                                                ((5, 33), torch.float32, False, True, None),
                                                ((3, 300), torch.float16, True, True, None),
                                                ((6, 2560), torch.float32, False, True, None),
                                                ((6, 5120), torch.float32, True, True, None)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        if zero_row:
            x[1] = 0
        w = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5
        sm = torch.rand(shape[-1], device="cuda", generator=gen) + 0.5 if smooth else None
        rows = x.numel() // shape[-1]
        run = lambda: rmsnorm_quant.rmsnorm_quant(x, w, 1e-6, sm)  # noqa: E731
        label = (f"rmsnorm_quant {shape} layout {rmsnorm_quant.layout(x, w, sm)} zero_row={zero_row} "
                 f"smooth={smooth}")
        compare("rmsnorm_quant", run, lambda: rmsnorm_quant.rmsnorm_quant_plain(x, w, 1e-6, sm), dtype, label,
                key is not None, key=None if key == "main" else key, check=check_quant,
                bound=(x.numel() * (x.element_size() + 1) + 4 * shape[-1] * (2 if smooth else 1) + 4 * rows,
                       6 * x.numel(), "fp32"))
        for i in range(2):
            _repeats(torch, f"{label} output {i}", lambda i=i: run()[i])
    log("kernel rmsnorm_quant", "every E case repeats bit for bit")

    # F: int8 GEMM at every w8a8 projection shape (prefill M = T, decode M = 8), the lm_head at M = 4,
    # a (K, N) weight at ragged M, three output dtypes; unit scales + fp32 output must be exact
    def exact(got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"GEMM int32 sums differ: max {(got - want).abs().max().item()}")
        return "exact"

    def int_gemm_bound(M, K, N, weight_bytes, out_dtype):
        return (M * K + weight_bytes + 4 * (M + N) + M * N * (torch.finfo(out_dtype).bits // 8), 2 * M * N * K,
                "int8")

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def gemm_case(M, K, N, trans, dtype, unit, main, key=None):
        w = torch.randint(-127, 128, (N, K) if trans else (K, N), device="cuda", generator=gen, dtype=torch.int8)
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        xs = torch.ones(M, 1, device="cuda") if unit else torch.rand(M, 1, device="cuda", generator=gen) * 0.1
        ws = torch.ones(N, device="cuda") if unit else torch.rand(N, device="cuda", generator=gen) * 1e-3
        # torch._int_mm: the int32 product without the dequant epilogue; it takes M > 16 and N % 8 == 0 only
        lib = (lambda: torch._int_mm(x, w.t())) if trans and M > 16 and N % 8 == 0 else None
        run = lambda: int8_matmul.int8_scaled_matmul(x, w, xs, ws, trans, dtype)  # noqa: E731
        label = (f"int8 gemm M={M} K={K} N={N} trans={trans} unit_scales={unit} "
                 f"route {tuple(int8_matmul.route(M, N, K, trans, sms))}")
        compare("int8_matmul", run, lambda: int8_matmul.int8_scaled_matmul_plain(x, w, xs, ws, trans, dtype), dtype,
                label, main, key=key, check=exact if unit else None, bound=int_gemm_bound(M, K, N, N * K, dtype),
                library=lib)
        _repeats(torch, label, run)

    # Qwen3-4B's and Seed-OSS-36B's projections at prefill (the wgmma route) and decode (split K where the output
    # tiles leave SMs idle), each timed, beside torch._int_mm at prefill
    for K, N in GEMM_SHAPES + SEED_OSS_GEMM_SHAPES:
        for M in (T, 8):
            gemm_case(M, K, N, True, bf16, False, True, key=f"{M}x{K}x{N}")
            gemm_case(M, K, N, True, torch.float32, True, False)
    gemm_case(4, hidden, 151936, True, bf16, False, True, key=f"4x{hidden}x151936")
    # the wgmma route at ragged M, N and K (K % 128 != 0) and at an N that fills no 16-byte vector of the output; the
    # decode route's K split at a ragged shape
    for M, K, N in ((130, 272, 400), (70, 144, 37), (5, 272, 400)):
        for dtype in (bf16, torch.float16, torch.float32):
            gemm_case(M, K, N, True, dtype, False, False)
        gemm_case(M, K, N, True, torch.float32, True, False)
    for M in (1, 7, 130):
        for dtype in (bf16, torch.float16, torch.float32):
            gemm_case(M, 272, 400, False, dtype, False, False)
        gemm_case(M, 272, 400, False, torch.float32, True, False)
    log("kernel int8_matmul", "every F case repeats bit for bit over two runs")

    # G: packed-int4 GEMM at every w4a8 projection shape (the draft's decode M = 1, M = 5, its prefill
    # M = 512), ragged M in three output dtypes, a split prefill at one and two m tiles; unit scales + fp32 output
    # must be exact; every case repeats bit for bit; an N that is not a multiple of 128 must be refused. Each main
    # case also times F (int8_matmul) on the unpacked weight at the same shape: a reference kernel of this port, not
    # a library call
    def int4_case(M, K, N, dtype, unit, main, key=None):
        wp = torch.randint(-128, 128, (N // 2, K), device="cuda", generator=gen, dtype=torch.int8)
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        xs = torch.ones(M, 1, device="cuda") if unit else torch.rand(M, 1, device="cuda", generator=gen) * 0.1
        ws = torch.ones(N, device="cuda") if unit else torch.rand(N, device="cuda", generator=gen) * 1e-2
        run = lambda: int4_matmul.int4_scaled_matmul(x, wp, xs, ws, dtype)  # noqa: E731
        plan = int4_matmul.route(M, N, K, sms)
        label = (f"int4 gemm M={M} K={K} N={N} unit_scales={unit} route "
                 f"{int4_matmul.ROUTE_NAMES[plan.code]}/{plan.splits}/{plan.warps}")
        compare("int4_matmul", run, lambda: int4_matmul.int4_scaled_matmul_plain(x, wp, xs, ws, dtype), dtype, label,
                main, key=key, check=exact if unit else None, bound=int_gemm_bound(M, K, N, N * K // 2, dtype))
        _repeats(torch, label, run)
        if main:
            w8 = int4_matmul.unpack_int4_rows(wp)
            entry = record["int4_matmul"][key]
            entry["f_unpacked_ms"] = graph_ms(
                torch, lambda: int8_matmul.int8_scaled_matmul(x, w8, xs, ws, True, dtype))
            log("kernel int4_matmul", f"{label}: F on the unpacked int8 weight (reference, not a library call) "
                                      f"{entry['f_unpacked_ms']:.4f} ms against G's {entry['ms']:.4f}")

    for K, N in GEMM_SHAPES:
        for M in INT4_MS:
            int4_case(M, K, N, bf16, False, True, key=f"{M}x{K}x{N}")
            int4_case(M, K, N, torch.float32, True, False)
    for M in (130, 17, 3):
        for dtype in (bf16, torch.float16, torch.float32):
            int4_case(M, 272, 384, dtype, False, False)
    int4_case(17, 272, 384, torch.float32, True, False)
    for M in (130, 40):  # K split over the wgmma units
        int4_case(M, 2560, 1024, torch.float32, True, False)
        int4_case(M, 2560, 1024, bf16, False, False)
    log("kernel int4_matmul", "every G case repeats bit for bit over two runs")
    x = torch.zeros(4, 256, device="cuda", dtype=torch.int8)
    try:
        int4_matmul.int4_scaled_matmul(x, torch.zeros(96, 256, device="cuda", dtype=torch.int8),
                                       torch.ones(4, device="cuda"), torch.ones(192, device="cuda"), bf16)
    except ValueError as e:
        log("kernel int4_matmul", f"N = 192 refused: {e}")
    else:
        raise AssertionError("the int4 GEMM took N = 192 (N % 128 != 0)")

    _gmm_cases(torch, compare, gen, record)
    _gqmm_cases(torch, compare, gen, record)
    _mla_cases(torch, compare, gen)
    _queue3_cases(torch, gen)
    _flash_swa_cases(torch, compare, gen)
    _train_kernel_cases(torch, compare, gen)
    _flce_cases(torch, compare, gen, record)
    _flash_diffusion_cases(torch, compare, gen)
    _residual_add_cases(torch, compare, gen)
    _conv1d_cases(torch, compare, gen)
    return record


def _prefill_cases(torch, compare, gen, record) -> None:
    """D / D': prefill of the main path's batch (main, beside SDPA over the padded prompt rows); chunked, empty,
    short, ABAB, HND, D 64/128/256, block sizes 16 and 32 (below the 64-key tile), Seed-OSS-36B's group 10 (80/8,
    which does not divide 64) and group 64; D 96 and 80 at the next instantiated width (bf16, fp32, fp16) and groups
    71/1 and 130/1 in chunks of <= 64 heads (bf16, fp32, fp16), the widened head_dims then shown to store nothing
    past their columns (``_stores_within``); int8 pages, at D 96 and group 71/1 too. Every output to its dtype's
    ladder and, relative to its size (whole tensor, worst (token, head) row), to PAGED_PREFILL_REL_LIMITS; every
    bf16/fp16 case of D and D' repeats bit for bit over two runs."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import paged_decode, paged_prefill
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    H, Hkv, D = 32, 8, 128

    def causal_pairs(q_lens, kv_lens):
        return sum(q * (kv - q) + q * (q + 1) // 2 for q, kv in zip(q_lens, kv_lens))

    def pages(lens, bs):
        """(blocks, table columns) for a batch of these kv lengths at block size bs."""
        return max(4 * 69, sum(-(-n // bs) for n in lens)), max(69, -(-max(lens) // bs))

    # (dtype, layout, gqa, hq, hkv, d, q_lens, kv_lens, scale, block size, main)
    cases = [(bf16, "NHD", "AABB", H, Hkv, D, list(PROMPT_LENS), list(PROMPT_LENS), None, BLOCK_SIZE, True),
             (bf16, "HND", "ABAB", H, Hkv, D, [5, 0, 1, 40], [69, 0, 9, 40], None, BLOCK_SIZE, False),
             (f32, "NHD", "AABB", 8, 8, 64, [3, 70, 1], [3, 130, 0], 0.3, BLOCK_SIZE, False),
             (f16, "HND", "AABB", 16, 1, 256, [33, 7], [33, 100], None, BLOCK_SIZE, False),
             (f16, "NHD", "AABB", H, Hkv, D, [200, 37], [260, 37], None, BLOCK_SIZE, False),
             (bf16, "NHD", "AABB", 16, 2, 64, [129, 64], [129, 200], None, BLOCK_SIZE, False),
             (bf16, "HND", "ABAB", 8, 2, 256, [70, 3], [70, 40], 0.05, BLOCK_SIZE, False),
             (bf16, "NHD", "AABB", H, Hkv, D, [200, 37], [260, 37], None, 16, False),
             (f16, "HND", "ABAB", H, Hkv, 64, [90, 1, 33], [90, 70, 33], None, 32, False),
             (bf16, "NHD", "AABB", 80, 8, D, [300, 5], [300, 77], None, BLOCK_SIZE, False),
             (bf16, "HND", "ABAB", 80, 8, D, [61, 2], [100, 2], None, 16, False),
             (f16, "NHD", "AABB", 64, 1, D, [20, 3], [20, 50], None, BLOCK_SIZE, False),
             # head_dims at the next instantiated width, groups over 64 in chunks of <= 64 heads
             (bf16, "NHD", "AABB", 16, 2, 96, [200, 77, 1], [200, 77, 1], None, BLOCK_SIZE, False),
             (f32, "HND", "ABAB", 16, 2, 96, [70, 3], [130, 3], None, BLOCK_SIZE, False),
             (bf16, "NHD", "AABB", 71, 1, D, [200, 77, 1], [200, 77, 1], None, BLOCK_SIZE, False),
             (f32, "NHD", "AABB", 71, 1, 64, [40, 3], [90, 3], None, BLOCK_SIZE, False),
             (f16, "HND", "AABB", 130, 1, 80, [33, 5], [60, 5], None, 32, False)]
    for dtype, layout, gqa, hq, hkv, d, q_lens, kv_lens, scale, bs, main in cases:
        n_blocks, cols = pages(kv_lens, bs)
        kc, vc = _cache(torch, n_blocks, hkv, bs, d, layout, dtype, gen)
        bt = _tables(torch, kv_lens, bs, cols, n_blocks, gen)
        cu_q, cu_kv = _cu(torch, q_lens), _cu(torch, kv_lens)
        q = torch.randn(sum(q_lens), hq, d, device="cuda", generator=gen).to(dtype)
        lib = None
        if main:  # SDPA over the padded prompt rows (q = kv here) and the pages gathered beforehand, causal + padding
            S = max(kv_lens)
            k_dense, v_dense = (_dense_pages(torch, cache, bt, kv_lens, layout) for cache in (kc, vc))
            lens_t = torch.tensor(q_lens, device="cuda")
            at = (torch.repeat_interleave(torch.arange(len(q_lens), device="cuda"), lens_t),
                  torch.cat([torch.arange(n, device="cuda") for n in q_lens]))
            q_pad = q.new_zeros(len(q_lens), S, hq, d)
            q_pad[at] = q
            q_pad = q_pad.transpose(1, 2).contiguous()
            pos = torch.arange(S, device="cuda")
            # (B, 1, S, S): a key is seen at or below the row and inside its sequence
            mask = ((pos[None, :] <= pos[:, None])[None] & (pos < lens_t[:, None])[:, None])[:, None]
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q_pad, k_dense, v_dense, attn_mask=mask, enable_gqa=True)
            check_tol_diff(lib().transpose(1, 2)[at],
                           paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, bt, scale, cu_kv, gqa, layout),
                           **tols_for(dtype))  # the library call computes the same function
        run = lambda: paged_prefill.paged_prefill_gqa(q, kc, vc, cu_q, bt, scale, cu_kv, gqa, layout,  # noqa: E731
                                                      max_q_len=max(q_lens))
        label = f"prefill {layout} {gqa} {hq}/{hkv}x{d} bs {bs} q={q_lens} kv={kv_lens} scale={scale}"
        compare("paged_prefill", run,
                lambda: paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, bt, scale, cu_kv, gqa, layout),
                dtype, label, main, check=_rel_checker(torch, PAGED_PREFILL_REL_LIMITS, dtype),
                bound=attention_bound(torch, dtype, hq, hkv, d, sum(q_lens), kv_lens, causal_pairs(q_lens, kv_lens),
                                      kc.element_size()), library=lib)
        if dtype != f32:
            _repeats(torch, label, run)
        if d not in paged_decode.HEAD_DIMS:
            _stores_within(torch, label, "mojo_paged_prefill", 8, run)
        del kc, vc
    int8_cases = [(bf16, "AABB", H, Hkv, D, list(PROMPT_LENS), list(PROMPT_LENS), BLOCK_SIZE, True),
                  (bf16, "ABAB", H, Hkv, D, [5, 0, 1, 40], [69, 0, 9, 40], BLOCK_SIZE, False),
                  (f32, "AABB", 8, 8, 64, [3, 70, 1], [3, 130, 0], BLOCK_SIZE, False),
                  (f16, "AABB", 16, 1, 256, [33, 7], [33, 100], BLOCK_SIZE, False),
                  (f16, "ABAB", H, Hkv, D, [200, 37], [260, 37], 16, False),
                  (bf16, "AABB", 16, 2, 64, [129, 64], [129, 200], 32, False),
                  (bf16, "AABB", 80, 8, D, [300, 5], [300, 77], BLOCK_SIZE, False),
                  (bf16, "AABB", 16, 2, 96, [200, 77, 1], [200, 77, 1], BLOCK_SIZE, False),
                  (f32, "ABAB", 71, 1, 96, [30, 2], [70, 2], 32, False)]
    for dtype, gqa, hq, hkv, d, q_lens, kv_lens, bs, main in int8_cases:
        n_blocks, cols = pages(kv_lens, bs)
        (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, bs, d, gen)
        bt = _tables(torch, kv_lens, bs, cols, n_blocks, gen)
        cu_q, cu_kv = _cu(torch, q_lens), _cu(torch, kv_lens)
        q = torch.randn(sum(q_lens), hq, d, device="cuda", generator=gen).to(dtype)
        run = lambda: paged_prefill.paged_prefill_gqa(q, kc, vc, cu_q, bt, None, cu_kv, gqa, "HND",  # noqa: E731
                                                      max_q_len=max(q_lens), key_scale=ks, value_scale=vs)
        label = f"prefill int8 pages HND {gqa} {hq}/{hkv}x{d} bs {bs} q={q_lens} kv={kv_lens}"
        compare("paged_prefill", run,
                lambda: paged_prefill.paged_prefill_gqa_plain(q, kc, vc, cu_q, bt, None, cu_kv, gqa, "HND",
                                                              key_scale=ks, value_scale=vs),
                dtype, label, main, key="int8_pages", check=_rel_checker(torch, PAGED_PREFILL_REL_LIMITS, dtype),
                bound=attention_bound(torch, dtype, hq, hkv, d, sum(q_lens), kv_lens, causal_pairs(q_lens, kv_lens),
                                      1))
        if dtype != f32:
            _repeats(torch, label, run)
        if d not in paged_decode.HEAD_DIMS:
            _stores_within(torch, label, "mojo_paged_prefill", 8, run)
        del kc, vc
    torch.cuda.empty_cache()
    log("kernel paged_prefill", "every bf16/fp16 D and D' case repeats bit for bit over two runs")


def _gmm_cases(torch, compare, gen, record) -> None:
    """H: grouped GEMM at the MoE path's shapes (the Qwen3-30B-A3B experts, (G, N, K) weights, counts of a random
    top-8 routing over 128 experts), then empty and 1-row groups, ragged M, K and N, rows past the groups' end,
    both layouts, three dtypes, prefill tiles that straddle groups at G = 256; DeepSeek-V3's routed experts (G =
    256) at decode and prefill. Every output to its dtype's ladder and, relative to its size (whole tensor, worst
    row), to GROUP_GEMM_REL_LIMITS; every bf16/fp16 case on the prefill tile (M >= 32 G) repeats bit for bit."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import group_gemm

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    route_rng = np.random.default_rng(2)

    def routed_counts(rows, experts=128, top_k=8):
        choice = np.argsort(route_rng.random((rows // top_k, experts)), axis=1)[:, :top_k]
        return np.bincount(choice.reshape(-1), minlength=experts)

    def gmm_case(counts, K, N, trans, dtype, main, key=None, M=None, w=None):
        counts = torch.tensor(np.asarray(counts), dtype=torch.int32, device="cuda")
        G, routed = counts.numel(), int(counts.sum())
        M = routed if M is None else M
        if w is None:
            w = (torch.randn((G, N, K) if trans else (G, K, N), device="cuda", generator=gen) * 0.05).to(dtype)
        x = torch.randn(M, K, device="cuda", generator=gen).to(dtype)
        isz, active = x.element_size(), int((counts > 0).sum())
        bound = ((M * K + active * N * K + M * N) * isz + 4 * G, 2 * routed * K * N, _kind(torch, dtype))
        lib = None
        if main and hasattr(torch, "_grouped_mm"):
            offs = torch.cumsum(counts, 0, dtype=torch.int32)
            w_kn = w.transpose(-2, -1) if trans else w
            lib = lambda: torch._grouped_mm(x, w_kn, offs=offs)  # noqa: E731
        run = lambda: group_gemm.grouped_matmul(x, w, counts, trans)  # noqa: E731
        label = f"group gemm{' ' + key if key else ''} M={M} K={K} N={N} G={G} ({active} active) trans={trans}"
        compare("group_gemm", run, lambda: group_gemm.grouped_matmul_plain(x, w, counts, trans), dtype, label, main,
                key=key, check=_rel_checker(torch, GROUP_GEMM_REL_LIMITS, dtype), bound=bound, library=lib)
        if dtype != f32 and M >= 32 * G:
            _repeats(torch, label, run)

    for name, M, K, N in GMM_SHAPES:
        gmm_case(routed_counts(M), K, N, True, bf16, True, key=name)
    for dtype in (bf16, f16, f32):
        for trans in (True, False):
            gmm_case([0, 5, 1, 0, 17, 3], 72, 40, trans, dtype, False)                 # M 26, ragged K and N
            gmm_case([300, 0, 1, 37], 136, 264, trans, dtype, False)                    # the prefill tile
            gmm_case([1] * 9 + [0] * 7, 2048, 96, trans, dtype, False)                  # 1-row groups (decode)
            gmm_case([3, 0, 9], 64, 48, trans, dtype, False, M=21)                      # rows past the groups
            gmm_case([130, 0, 64, 1, 200], 200, 136, trans, dtype, False, M=420)        # prefill tile, rows past
    gmm_case([7, 0, 2], 33, 17, True, f32, False)                                       # fp32 takes any K, N
    # prefill tiles that straddle two groups at G = 256: ~36 rows an expert, empty and one-row groups among them
    straddle = routed_counts(9216, experts=256)
    straddle[[3, 100]], straddle[[7, 200]] = 0, 1
    for dtype in (bf16, f16):
        for trans in (True, False):
            gmm_case(straddle, 256, 384, trans, dtype, False)
    try:
        group_gemm.grouped_matmul(torch.zeros(4, 60, device="cuda", dtype=bf16),
                                  torch.zeros(2, 16, 60, device="cuda", dtype=bf16),
                                  torch.tensor([2, 2], dtype=torch.int32, device="cuda"), True)
    except ValueError as e:
        log("kernel group_gemm", f"K = 60 in bf16 refused: {e}")
    else:
        raise AssertionError("the grouped GEMM took K = 60 in bf16 (K % 8 != 0)")
    if record["group_gemm"]["decode_bs1_fc1"]["library_ms"] is None:
        log("kernel group_gemm", f"torch {torch.__version__} has no torch._grouped_mm: library_ms none")
    # H at G = 256: DeepSeek-V3's routed experts (top-8 of 256) at decode (bs 4) and over the prefill batch; the
    # weights are drawn in bf16 (fc1 alone is 15 GB)
    for name, K, N in (("fc1", 7168, 2 * 2048), ("down", 2048, 7168)):
        w = torch.randn((256, N, K), device="cuda", generator=gen, dtype=bf16).mul_(0.05)
        for rows, phase in ((4 * 8, "decode_bs4"), (sum(PROMPT_LENS) * 8, "prefill")):
            gmm_case(routed_counts(rows, experts=256), K, N, True, bf16, True, key=f"deepseek_{phase}_{name}", w=w)
        del w
    torch.cuda.empty_cache()
    log("kernel group_gemm", "every bf16/fp16 prefill-tile case repeats bit for bit over two runs")


def _gqmm_cases(torch, compare, gen, record) -> None:
    """R: the int8 / packed-int4 grouped GEMM at the quantized MoE paths' shapes (Qwen3-30B-A3B's fc1 and down, G
    128, int8 and int4; DeepSeek-V3's, G 256, int8; decode at bs 4, 32 rows from one top-8 routing, and the
    prefill batch's 13200 rows), then groups of 0, 1, 15, 16, 17 and 129 rows, an empty tail, both tiles and every
    output dtype. Every case equals the plain version bit for bit and repeats bit for bit; each main case is timed
    from one CUDA graph beside its bound and H's bf16 time on the same (M, K, N, counts), a reference: no PyTorch
    call computes an int8 grouped product, so R has no library time."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import group_gemm, group_quant_gemm
    from mojo_opset_tpu_torch.modeling.qwen3 import pack_int4

    bf16 = torch.bfloat16
    route_rng = np.random.default_rng(3)

    def routed_counts(rows, experts, top_k=8):
        choice = np.argsort(route_rng.random((rows // top_k, experts)), axis=1)[:, :top_k]
        return np.bincount(choice.reshape(-1), minlength=experts)

    def bit_for_bit(got, want):
        if not torch.equal(got, want):
            raise AssertionError(f"R differs from its plain version at {int((got != want).sum())} elements")
        return "bit for bit"

    def case(counts, K, N, int4, dtype, main=False, key=None, M=None, w=None):
        counts = torch.tensor(np.asarray(counts), dtype=torch.int32, device="cuda")
        G, routed = counts.numel(), int(counts.sum())
        M = routed if M is None else M
        if w is None:
            lo, hi = (-8, 8) if int4 else (-127, 128)
            w = torch.randint(lo, hi, (G, N, K), device="cuda", generator=gen, dtype=torch.int8)
            w = pack_int4(w) if int4 else w
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
        ws = torch.rand(G, N, device="cuda", generator=gen) * 0.01 + 1e-3
        xs = torch.rand(M, 1, device="cuda", generator=gen) * 0.05 + 1e-3
        run = lambda: group_quant_gemm.grouped_quant_matmul(x, w, counts, ws, xs, dtype, int4)  # noqa: E731
        active = int((counts > 0).sum())
        out_bytes = torch.finfo(dtype).bits // 8
        # each input read once (the active experts' slabs and scales, x, x's scales, the counts), the output once
        bound = (active * (w.shape[1] * K + 4 * N) + M * (K + 4) + 4 * G + M * N * out_bytes, 2 * routed * K * N,
                 "int8")
        route = group_quant_gemm.ROUTE_NAMES[group_quant_gemm.route(M, G)]
        label = (f"grouped quant gemm{' ' + key if key else ''} M={M} K={K} N={N} G={G} ({active} active) "
                 f"{'int4' if int4 else 'int8'} {route} tile")
        note = None
        if main:
            xb = torch.randn(M, K, device="cuda", generator=gen, dtype=bf16)
            wb = torch.randn(G, N, K, device="cuda", generator=gen, dtype=bf16)
            h_ms = graph_ms(torch, lambda: group_gemm.grouped_matmul(xb, wb, counts, True))
            del xb, wb
            note = f"H in bf16 on the same shapes {h_ms:.4f} ms (a reference); library none: no PyTorch call " \
                   f"computes an int8 grouped product"
        compare("group_quant_gemm", run, lambda: group_quant_gemm.grouped_quant_matmul_plain(
            x, w, counts, ws, xs, dtype, int4), dtype, label, main, key=key, check=bit_for_bit, bound=bound, note=note)
        _repeats(torch, label, run)
        if main:
            record["group_quant_gemm"][key]["h_bf16_ms"] = h_ms
        return w

    for int4 in (False, True):
        suffix = "_int4" if int4 else ""
        for name, rows, K, N in (("decode_bs4_fc1", 32, 2048, 1536), ("decode_bs4_down", 32, 768, 2048),
                                 ("prefill_fc1", sum(PROMPT_LENS) * 8, 2048, 1536),
                                 ("prefill_down", sum(PROMPT_LENS) * 8, 768, 2048)):
            case(routed_counts(rows, 128), K, N, int4, bf16, True, key=name + suffix)
    for name, K, N in (("fc1", 7168, 2 * 2048), ("down", 2048, 7168)):
        w = None
        for rows, phase in ((4 * 8, "decode_bs4"), (sum(PROMPT_LENS) * 8, "prefill")):
            w = case(routed_counts(rows, 256), K, N, False, bf16, True, key=f"deepseek_{phase}_{name}", w=w)
        del w
        torch.cuda.empty_cache()
    edges = [0, 1, 15, 16, 17, 129, 0, 3]
    for dtype in (bf16, torch.float16, torch.float32):
        for int4 in (False, True):
            case(edges, 64, 48, int4, dtype, M=sum(edges) + 21)          # the decode tile, an empty tail
            case([300, 0, 1, 37, 129], 160, 264, int4, dtype, M=500)       # the prefill tile, an empty tail
            case(routed_counts(32, 16), 2048, 96, int4, dtype)             # one-row groups
            case([7, 0, 2], 48, 34, int4, dtype)                           # N off the tiles, K of 3 chunks
    try:
        group_quant_gemm.grouped_quant_matmul(
            torch.zeros(4, 40, device="cuda", dtype=torch.int8),
            torch.zeros(2, 16, 40, device="cuda", dtype=torch.int8),
            torch.tensor([2, 2], dtype=torch.int32, device="cuda"), torch.ones(2, 16, device="cuda"),
            torch.ones(4, 1, device="cuda"), bf16)
    except ValueError as e:
        log("kernel group_quant_gemm", f"K = 40 refused: {e}")
    else:
        raise AssertionError("the grouped quant GEMM took K = 40 (K % 16 != 0)")
    log("kernel group_quant_gemm", "every R case equals its plain version and repeats, bit for bit")


def attention_bound(torch, dtype, hq, hkv, d, q_tokens, kv_lens, pairs, page_bytes):
    """Bytes: q, the K/V rows these lengths read, out; operations: QK and PV over ``pairs``."""
    isz = torch.finfo(dtype).bits // 8
    return (2 * q_tokens * hq * d * isz + 2 * sum(kv_lens) * hkv * d * page_bytes, 4 * hq * d * pairs,
            _kind(torch, dtype))


def _repeats(torch, name, fn) -> None:
    """Two runs of a kernel on the same inputs give the same bits."""
    if not torch.equal(fn(), fn()):
        raise AssertionError(f"{name}: two runs on the same inputs differ")


STORE_GUARD_BYTES = 4096


def _stores_within(torch, name, entry, out_index, run) -> None:
    """A kernel that runs a head_dim at a wider instantiated width (zeros past it in shared memory) stores none of
    the columns past it: ``run()`` (one wrapper call) again, with entry point ``entry``'s output (its launch
    argument ``out_index``) sent to a buffer of the output's bytes followed by STORE_GUARD_BYTES of 0xff. The guard
    must stay 0xff (the last head's padded columns would land there) and the output equal the first call's bit for
    bit (the other heads' padded columns would land on their neighbours')."""
    from mojo_opset_tpu_torch.backends.cuda import build

    want = run()
    torch.cuda.synchronize()
    nbytes = want.numel() * want.element_size()
    buf = torch.full((nbytes + STORE_GUARD_BYTES,), 0xFF, dtype=torch.uint8, device="cuda")
    real = build.launch

    def launch(entry_name, device, *args):
        if entry_name == entry:
            args = (*args[:out_index], buf.data_ptr(), *args[out_index + 1:])
        real(entry_name, device, *args)

    build.launch = launch
    try:
        run()
    finally:
        build.launch = real
    torch.cuda.synchronize()
    if not bool((buf[nbytes:] == 0xFF).all()):
        raise AssertionError(f"{name}: {entry} stored past its output's last column")
    if not torch.equal(buf[:nbytes], want.contiguous().view(-1).view(torch.uint8)):
        raise AssertionError(f"{name}: {entry} into a buffer of its own differs from the first call")
    log(f"kernel {entry.removeprefix('mojo_')}", f"{name}: nothing stored past the output's {want.shape[-1]} "
                                                  f"columns (a {STORE_GUARD_BYTES}-byte guard after it untouched)")


def _padding_inert(torch, name, narrow_fn, wide_fn) -> None:
    """A wrapper that zero-pads head_dim d to the next instantiated width: its outputs (``narrow_fn()``, a tuple of
    head_dim tensors) equal bit for bit the first d columns of the same kernels run on inputs padded by hand at d's
    scale (``wide_fn()``), whose columns past d are exactly 0: the padding adds nothing and never reaches the
    output."""
    for i, (n, w) in enumerate(zip(narrow_fn(), wide_fn())):
        d = n.shape[-1]
        if not torch.equal(w[..., :d], n):
            raise AssertionError(f"{name}: output {i} differs from the hand-padded run's first {d} columns")
        if bool(w[..., d:].any()):
            raise AssertionError(f"{name}: output {i} has non-zero columns past head_dim {d} in the padded run")
    log("kernel padding", f"{name}: every output equals the hand-padded run's first columns, the rest exactly 0")


def _decode_cases(torch, compare, gen, record) -> None:
    """C / C': decode at the main path's lengths after prefill + decode (main, beside SDPA over the gathered pages),
    edge cases, groups 20 (40/2: a partial 16-head chunk) and 32 (32/1), int8 pages; head_dims 96 and 80 (bf16,
    fp32, fp16 at group 71/1, int8 pages at 96 in bf16 and fp32), run at the next instantiated width and held like
    the others, then shown to store nothing past their columns (``_stores_within``); Qwen3-4B's geometry at bs 1,
    8 and 24 at ctx 4000 beside SDPA; C and C' repeat bit for bit over two runs (the split merge runs in a fixed
    order)."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import paged_decode
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16 = torch.bfloat16
    H, Hkv, D = 32, 8, 128
    n_blocks = 4 * 69
    dec_lens = [n + DECODE_STEPS for n in PROMPT_LENS]

    def sdpa_over_pages(q, kc, vc, sl, bt, lens, layout, gqa, scale):
        """SDPA over the K/V pages gathered beforehand (the gather left out), a length mask on the keys; checked to
        compute the same function as the plain version."""
        k_dense, v_dense = (_dense_pages(torch, cache, bt, lens, layout) for cache in (kc, vc))
        mask = (torch.arange(max(lens), device="cuda") < sl[:, None])[:, None, None]
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], k_dense, v_dense, attn_mask=mask, enable_gqa=True)
        check_tol_diff(lib()[:, :, 0], paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, scale, gqa, layout),
                       **tols_for(q.dtype))
        return lib

    cases = [(bf16, "NHD", "AABB", H, Hkv, D, dec_lens, None, True, None),
             (bf16, "HND", "ABAB", H, Hkv, D, [0, 1, 64, 65], None, False, None),
             (torch.float32, "NHD", "AABB", 8, 8, 64, [17, 0, 130], 0.3, False, None),
             (bf16, "NHD", "ABAB", 12, 2, 128, [700, 9, 64], None, False, None),
             (torch.float16, "HND", "AABB", 16, 1, 256, [200, 3], None, False, None),
             (bf16, "NHD", "AABB", 40, 2, D, [1032, 0, 545, 39], None, False, None),
             (bf16, "HND", "ABAB", 40, 2, D, [700, 9, 64], None, False, None),
             (bf16, "NHD", "AABB", 32, 1, D, dec_lens, None, False, None),
             # head_dims run at the next instantiated width (zeros past them in shared memory)
             (bf16, "NHD", "AABB", 16, 2, 96, [300, 7, 0, 65], None, False, None),
             (torch.float32, "HND", "ABAB", 8, 2, 80, [130, 1, 64], None, False, None),
             (torch.float16, "NHD", "AABB", 71, 1, 96, [1000, 33], None, False, None)]
    # Qwen3-4B's geometry at the first benchmark's decode grid: bs 1, 8 and 24 at ctx 4000
    cases += [(bf16, "NHD", "AABB", H, Hkv, D, [4000] * bs, None, True, f"bs{bs}_ctx4000") for bs in DECODE_GRID_BS]
    for dtype, layout, gqa, hq, hkv, d, lens, scale, main, key in cases:
        blocks = max(n_blocks, sum(-(-n // BLOCK_SIZE) for n in lens))
        cols = max(69, -(-max(lens) // BLOCK_SIZE))
        kc, vc = _cache(torch, blocks, hkv, BLOCK_SIZE, d, layout, dtype, gen)
        bt = _tables(torch, lens, BLOCK_SIZE, cols, blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        lib = sdpa_over_pages(q, kc, vc, sl, bt, lens, layout, gqa, scale) if main else None
        run = lambda: paged_decode.paged_decode_gqa(q, kc, vc, sl, bt, scale, gqa, layout)  # noqa: E731
        compare("paged_decode", run,
                lambda: paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, scale, gqa, layout),
                dtype, f"decode {layout} {gqa} {hq}/{hkv}x{d} lens={lens[:4]}{'...' if len(lens) > 4 else ''} "
                       f"scale={scale}", main, key=key,
                bound=attention_bound(torch, dtype, hq, hkv, d, len(lens), lens, sum(lens), kc.element_size()),
                library=lib)
        _repeats(torch, f"decode {hq}/{hkv} lens={lens[:4]}", run)
        if d not in paged_decode.HEAD_DIMS:
            _stores_within(torch, f"decode {hq}/{hkv}x{d}", "mojo_paged_decode", 7, run)
        del kc, vc
    int8_cases = [(bf16, "AABB", H, Hkv, D, dec_lens, True),
                  (bf16, "ABAB", H, Hkv, D, [0, 1, 64, 65], False),
                  (torch.float32, "AABB", 8, 8, 64, [17, 0, 130], False),
                  (torch.float16, "ABAB", 16, 2, 256, [200, 3], False),
                  (bf16, "AABB", 40, 2, D, [1032, 0, 545, 39], False),
                  (bf16, "ABAB", 32, 1, D, dec_lens, False),
                  (bf16, "AABB", 16, 2, 96, [300, 7, 0, 65], False),
                  (torch.float32, "ABAB", 8, 2, 96, [130, 1, 64], False)]
    for dtype, gqa, hq, hkv, d, lens, main in int8_cases:
        (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, BLOCK_SIZE, d, gen)
        bt = _tables(torch, lens, BLOCK_SIZE, 69, n_blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        run = lambda: paged_decode.paged_decode_gqa(q, kc, vc, sl, bt, None, gqa, "HND", ks, vs)  # noqa: E731
        compare("paged_decode", run,
                lambda: paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, None, gqa, "HND", ks, vs),
                dtype, f"decode int8 pages HND {gqa} {hq}/{hkv}x{d} lens={lens}", main, key="int8_pages",
                bound=attention_bound(torch, dtype, hq, hkv, d, len(lens), lens, sum(lens), 1))
        _repeats(torch, f"decode int8 pages {hq}/{hkv} lens={lens}", run)
        if d not in paged_decode.HEAD_DIMS:
            _stores_within(torch, f"decode int8 pages {hq}/{hkv}x{d}", "mojo_paged_decode", 7, run)
        del kc, vc
    torch.cuda.empty_cache()
    log("kernel paged_decode", "every C and C' case repeats bit for bit over two runs")


def _decode_window_cases(torch, compare, gen, record) -> None:
    """C / C' with the TPU kernel's windows: a long context (ctx 32768, B 4, local 1024 and global 64) timed beside
    the same case without windows (the kernel skips the pages outside the window: under half the time), then local
    only, global only, a window at least as long as the context, seq_len 0, both layouts and GQA orders, int8
    pages, fp16 and fp32."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import paged_decode

    H, Hkv, D, bf16 = 32, 8, 128, torch.bfloat16
    ctx_lens, n_long = [32768] * 4, 4 * 32768 // BLOCK_SIZE
    window_ms = {}
    for dtype, layout, gqa, hq, hkv, d, lens, lws, gws, int8, key in (
            (bf16, "NHD", "AABB", H, Hkv, D, ctx_lens, 1024, 64, False, "window_ctx32k"),
            (bf16, "NHD", "AABB", H, Hkv, D, ctx_lens, None, None, False, "no_window_ctx32k"),
            (bf16, "HND", "AABB", H, Hkv, D, ctx_lens, 1024, 64, True, "window_ctx32k_int8"),
            (bf16, "HND", "AABB", H, Hkv, D, ctx_lens, None, None, True, "no_window_ctx32k_int8"),
            (bf16, "NHD", "ABAB", H, Hkv, D, [700, 0, 65, 1], 64, None, False, None),
            (bf16, "HND", "AABB", H, Hkv, D, [700, 0, 65, 1], None, 100, False, None),
            (torch.float32, "NHD", "AABB", 8, 8, 64, [300, 17, 0], 40, 3, False, None),
            (torch.float16, "HND", "ABAB", 16, 2, 256, [200, 3], 5000, None, False, None),
            (bf16, "HND", "ABAB", H, Hkv, D, [700, 0, 65, 1], 64, 16, True, None),
            (torch.float32, "HND", "AABB", 8, 8, 64, [300, 17, 0], None, 0, True, None)):
        blocks = n_long if lens is ctx_lens else 4 * 69
        cols = -(-max(lens) // BLOCK_SIZE)
        if int8:
            (kc, vc), (ks, vs) = _int8_cache(torch, blocks, hkv, BLOCK_SIZE, d, gen)
        else:
            (kc, vc), (ks, vs) = _cache(torch, blocks, hkv, BLOCK_SIZE, d, layout, dtype, gen), (None, None)
        bt = _tables(torch, lens, BLOCK_SIZE, cols, blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        isz = q.element_size()
        kept = [n if lws is None and gws is None else
                len(set(range(max(n - 1 - lws, 0), n) if lws is not None else ()) | set(range(min(gws or 0, n))))
                for n in lens]
        compare("paged_decode",
                lambda: paged_decode.paged_decode_gqa(q, kc, vc, sl, bt, None, gqa, layout, ks, vs, lws, gws),
                lambda: paged_decode.paged_decode_gqa_plain(q, kc, vc, sl, bt, None, gqa, layout, ks, vs, lws, gws),
                dtype, f"decode {'int8 pages ' if int8 else ''}{layout} {gqa} {hq}/{hkv}x{d} lens={lens[:4]} "
                       f"local={lws} global={gws} ({sum(kept)} keys kept)", key is not None, key=key,
                bound=(2 * len(lens) * hq * d * isz + 2 * sum(kept) * hkv * d * kc.element_size(),
                       4 * hq * d * sum(kept), _kind(torch, dtype)))
        if key is not None:
            window_ms[key] = record["paged_decode"][key]["ms"]
        del kc, vc
    torch.cuda.empty_cache()
    for suffix in ("", "_int8"):
        ratio = window_ms[f"window_ctx32k{suffix}"] / window_ms[f"no_window_ctx32k{suffix}"]
        log("kernel paged_decode", f"ctx 32768, local 1024 + global 64{suffix.replace('_', ' ')}: "
                                   f"{ratio:.3f} of the time without windows")
        if not ratio < 0.5:
            raise AssertionError(f"the windowed decode takes {ratio:.3f} of the unwindowed time: pages outside "
                                 f"the window are read")


def _mla_cases(torch, compare, gen) -> None:
    """I: absorbed MLA attention at DeepSeek-V3's widths (H 128, r 512, dr 64, block 64, bf16): decode at bs 4
    over the main path's first-step contexts (main) and at bs 1, prefill's row mode over the prompt batch, decode
    at bs 1 over ctx 4096 and 32768 and at bs 24 over ctx 4000 (each timed beside SDPA as MQA: the (row, head)
    pairs as the query rows of the one latent head, no copy of it to the heads), then a zero-length sequence,
    -1 table padding, contexts off the block size, one page, H = 4 and 16, a sink, fp16 decode and prefill, fp32,
    r 256, r 1024 (one ring stage) and a tiny r 16 / dr 8 (a column block wider than r, K padded to 16). The
    output is fp32 in every case, computed in fp32 by both versions: the fp32 ladder. Every case repeats bit for
    bit over two runs (the split merge runs in a fixed order)."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import mla_decode
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, bs = torch.bfloat16, BLOCK_SIZE
    first_step = [n + 1 for n in PROMPT_LENS]  # the contexts of the first decode step: 1001, 514, 131, 8

    def mla_case(case, lens, dtype=bf16, H=128, r=512, dr=64, rows=None, sink=False, cols=17, main=False, key=None,
                 library=False):
        cols = max(cols, -(-max(lens) // bs))
        n_blocks = max(4 * 17 + 4, sum(-(-n // bs) for n in lens) + 4)
        c = torch.randn(n_blocks, 1, bs, r, device="cuda", generator=gen).to(dtype)
        pe = torch.randn(n_blocks, 1, bs, dr, device="cuda", generator=gen).to(dtype)
        table = _tables(torch, lens, bs, cols, n_blocks, gen)
        if rows is None:  # decode: one row per sequence
            seqs, limits = None, torch.tensor(lens, dtype=torch.int32, device="cuda")
        else:
            seqs = torch.tensor([s for s, _ in rows], dtype=torch.int32, device="cuda")
            limits = torch.tensor([n for _, n in rows], dtype=torch.int32, device="cuda")
        R = limits.numel()
        # absorbed queries of a DeepSeek scale (|q_lat . c| of a few units)
        q_lat = (torch.randn(R, H, r, device="cuda", generator=gen) * 0.05).to(dtype)
        q_pe = (torch.randn(R, H, dr, device="cuda", generator=gen) * 0.05).to(dtype)
        sk = torch.randn(H, device="cuda", generator=gen) if sink else None
        args = (q_lat, q_pe, c, pe, limits, table, seqs, sk)
        pairs = sum(n for _, n in rows) if rows is not None else sum(lens)
        isz = c.element_size()
        bound = (sum(lens) * (r + dr) * isz + R * H * (r + dr) * isz + R * H * r * 4,
                 2 * H * pairs * (2 * r + dr), _kind(torch, dtype))
        lib = None
        if library:  # SDPA as MQA over the latent gathered beforehand (the page gather and query padding left out)
            B, S = len(lens), max(lens)
            dense = torch.cat([c, pe], -1)[table.clamp(min=0).long()][:, :, 0].reshape(B, -1, r + dr)
            k = dense[:, None, :S].contiguous()  # (B, 1, S, r + dr): one kv head, never copied to the query heads
            v = dense[:, None, :S, :r].contiguous()
            # each sequence's query rows in order, padded to the most rows; a padding row sees one position
            row_seqs = list(range(B)) if rows is None else [s for s, _ in rows]
            slots, taken = [], {}
            for s in row_seqs:
                slots.append(taken.get(s, 0))
                taken[s] = slots[-1] + 1
            at = (torch.tensor(row_seqs, device="cuda"), torch.tensor(slots, device="cuda"))
            n_slots = max(slots) + 1
            q = q_lat.new_zeros(B, n_slots, H, r + dr)
            q[at] = torch.cat([q_lat, q_pe], -1)
            q = q.view(B, 1, n_slots * H, r + dr)  # every (row, head) a query row of the one head
            row_limits = torch.ones(B, n_slots, dtype=torch.int32, device="cuda")
            row_limits[at] = limits
            # (B, 1, rows x H, S): a position is seen below its row's causal-and-length limit, by each of its heads
            mask = (torch.arange(S, device="cuda") < row_limits[..., None])[:, :, None].expand(B, n_slots, H, S)
            mask = mask.reshape(B, 1, n_slots * H, S)
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, scale=1.0)
            # the library call computes the same function: its rows against the plain version (output in dtype)
            check_tol_diff(lib().view(B, n_slots, H, r)[at], mla_decode.mla_decode_absorbed_plain(*args),
                           **tols_for(dtype))
        run = lambda: mla_decode.mla_decode_absorbed(*args)  # noqa: E731
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits = 1 if dtype == torch.float32 else mla_decode.split_count(R, H, r, cols * bs, sms)
        compare("mla_decode", run, lambda: mla_decode.mla_decode_absorbed_plain(*args), dtype,
                f"{case} (splits {splits})", main, key=key, check=lambda got, want: check_fp32(got, want),
                bound=bound, library=lib)
        _repeats(torch, case, run)

    def check_fp32(got, want):
        check_tol_diff(got, want, **tols_for(torch.float32))
        return f"fp32 output: {tols_for(torch.float32)}"

    mla_case(f"mla decode bs 4 H 128 lens={first_step}", first_step, main=True, key="decode_bs4", library=True)
    mla_case(f"mla decode bs 1 H 128 lens={first_step[:1]}", first_step[:1], main=True, key="decode_bs1",
             library=True)
    prompt_rows = [(b, p + 1) for b, n in enumerate(PROMPT_LENS) for p in range(n)]  # causal limit of each row
    mla_case(f"mla prefill rows over {list(PROMPT_LENS)} ({len(prompt_rows)} rows)", list(PROMPT_LENS),
             rows=prompt_rows, main=True, key="prefill_rows", library=True)
    for n, ctx in ((1, 4096), (1, 32768), (24, 4000)):
        mla_case(f"mla decode bs {n} H 128 ctx {ctx}", [ctx] * n, main=True, key=f"decode_bs{n}_ctx{ctx}",
                 library=True)
    mla_case("mla decode zero-length, one page, off the block size", [0, 1, 64, 65])
    mla_case("mla decode -1 table padding", [3, 130], cols=6)
    mla_case("mla decode H 4", [100, 7], H=4)
    mla_case("mla decode H 16", [200, 64], H=16)
    mla_case("mla decode sink", [0, 77, 1001], sink=True)
    mla_case("mla prefill rows chunked, sink", [40, 300], rows=[(1, 300), (1, 299), (0, 21), (0, 0)], sink=True)
    mla_case("mla decode fp16", [300, 5], dtype=torch.float16, H=32)
    mla_case("mla decode fp32", [300, 5], dtype=torch.float32, H=32)
    fp16_rows = [(b, p + 1) for b, n in enumerate((130, 7)) for p in range(n)]
    mla_case("mla prefill rows fp16 over [130, 7]", [130, 7], dtype=torch.float16, rows=fp16_rows)
    mla_case("mla decode r 256", [700, 33, 0], r=256)
    mla_case("mla decode r 1024 (one ring stage), sink", [513, 64], r=1024, H=16, sink=True)
    mla_case("mla decode r 16 dr 8", [70, 3], r=16, dr=8, H=4, cols=6)
    log("kernel mla_decode", "every I case repeats bit for bit over two runs")


def _queue3_cases(torch, gen) -> None:
    """Shapes the cuda tier once refused and JAX computes, each through its op against the golden op on the same
    inputs (the dtype ladder; gradients through autograd): kernels C and C' at head_dim 96 (C in fp32 at 80), D and
    D' at 96, D at group 71/1 in bf16 and fp32, J at group 71/1 and at head_dim 96, forward and backward, O at
    head_dim 96 forward and backward (CudaSdpa's bool mask), each launching its kernel; then F and G at K 40
    (``CudaQuantGemm``) and H at 16-bit K 36 (``CudaGroupGemm``), each taking the golden: golden_calls + 1 and no
    launch."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaGroupGemm, CudaQuantGemm
    from mojo_opset_tpu_torch.core.operators import (
        MojoGroupGemm, MojoPagedDecodeGQA, MojoPagedPrefillGQA, MojoQuantGemm, MojoSdpa, MojoSWA,
    )
    from mojo_opset_tpu_torch.core.operators.gemm import pack_int4_rows
    from mojo_opset_tpu_torch.experimental.operators.kv_quant_attention import (
        MojoPagedDecodeGQAWithKVDequant, MojoPagedPrefillGQAWithKVDequant,
    )
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, bs = torch.bfloat16, BLOCK_SIZE

    def ops(cls, *a, **kw):
        """The op's cuda tier and its golden, built alike."""
        return cls.get_backend_impl("cuda")(*a, **kw), cls.get_backend_impl("ref")(*a, **kw)

    def held(case, kernel, got, want, dtype, golden_cls=None):
        """got against want on the dtype ladder; ``kernel`` launched (or, with ``golden_cls``, nothing launched and
        that class's golden_calls rose by one, counted by the caller)."""
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        for g, w in zip(got, want):
            check_tol_diff(g, w, **tols_for(dtype))
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        log("kernel queue 3", f"{case} {str(dtype).split('.')[-1]}: max_abs_err {err:.3g} against the golden op "
                              f"({tols_for(dtype)}); {kernel}")

    def launched(module, fn):
        before = module.launches
        out = fn()
        torch.cuda.synchronize()
        if module.launches == before:
            raise AssertionError(f"{module.__name__} did not launch")
        return out

    # C / C': paged decode at head_dim 96 (bf16, int8 pages) and 80 (fp32)
    for dtype, d, int8 in ((bf16, 96, False), (torch.float32, 80, False), (bf16, 96, True)):
        lens, hq, hkv = [300, 7, 0, 65], 16, 2
        n_blocks = sum(-(-n // bs) for n in lens) + 4
        bt = _tables(torch, lens, bs, 6, n_blocks, gen)
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q = torch.randn(len(lens), hq, d, device="cuda", generator=gen).to(dtype)
        if int8:
            (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, bs, d, gen)
            op, gold = ops(MojoPagedDecodeGQAWithKVDequant, compute_dtype=dtype)
            run = lambda: op(q, None, kc, ks, vc, vs, sl, bt)  # noqa: E731
            want = gold(q, None, kc, ks, vc, vs, sl, bt)
        else:
            kc, vc = _cache(torch, n_blocks, hkv, bs, d, "NHD", dtype, gen)
            op, gold = ops(MojoPagedDecodeGQA, kv_layout="NHD")
            run = lambda: op(q, kc, vc, sl, bt)  # noqa: E731
            want = gold(q, kc, vc, sl, bt)
        held(f"paged decode{' int8 pages' if int8 else ''} {hq}/{hkv} head_dim {d} lens={lens}", "C launched",
             launched(kernels.paged_decode, run), want, dtype)
    # D / D': paged prefill at head_dim 96 (bf16, int8 pages) and at group 71/1 (bf16, fp32)
    for dtype, hq, hkv, d, int8 in ((bf16, 16, 2, 96, False), (bf16, 16, 2, 96, True), (bf16, 71, 1, 128, False),
                                   (torch.float32, 71, 1, 64, False)):
        lens = [200, 77, 1]
        n_blocks = sum(-(-n // bs) for n in lens) + 4
        bt = _tables(torch, lens, bs, 6, n_blocks, gen)
        cu = _cu(torch, lens)
        q = torch.randn(sum(lens), hq, d, device="cuda", generator=gen).to(dtype)
        if int8:
            (kc, vc), (ks, vs) = _int8_cache(torch, n_blocks, hkv, bs, d, gen)
            op, gold = ops(MojoPagedPrefillGQAWithKVDequant, compute_dtype=dtype)
            run = lambda: op(q, None, kc, ks, vc, vs, cu, bt, None, cu, max_q_len=max(lens))  # noqa: E731
            want = gold(q, None, kc, ks, vc, vs, cu, bt, None, cu, max_q_len=max(lens))
        else:
            kc, vc = _cache(torch, n_blocks, hkv, bs, d, "NHD", dtype, gen)
            op, gold = ops(MojoPagedPrefillGQA, kv_layout="NHD")
            run = lambda: op(q, kc, vc, cu, bt, None, cu, max_q_len=max(lens))  # noqa: E731
            want = gold(q, kc, vc, cu, bt, None, cu)
        held(f"paged prefill{' int8 pages' if int8 else ''} {hq}/{hkv} head_dim {d} lens={lens}", "D launched",
             launched(kernels.paged_prefill, run), want, dtype)
    # J: causal varlen attention at group 71/1 and at head_dim 96, forward and backward (autograd)
    for hq, hkv, d in ((71, 1, 128), (16, 4, 96)):
        lens = [256, 129]
        cu = _cu(torch, lens)
        x = [torch.randn(sum(lens), h, d, device="cuda", generator=gen).to(bf16) for h in (hq, hkv, hkv)]
        do = torch.randn(sum(lens), hq, d, device="cuda", generator=gen).to(bf16)
        outs = []
        for op in ops(MojoSWA):
            leaves = [t.clone().requires_grad_(True) for t in x]
            y = op(*leaves, cu, cu)
            outs.append((y.detach(), *torch.autograd.grad(y, leaves, do)))
        torch.cuda.synchronize()
        held(f"swa causal {hq}/{hkv} head_dim {d} lens={lens}: o, dq, dk, dv", "J forward, dq and dk/dv launched",
             outs[0], outs[1], bf16)
    # O: SDPA under a bool (causal) mask at head_dim 96, forward and backward
    B, hq, hkv, S, d = 2, 8, 2, 200, 96
    x = [torch.randn(B, h, S, d, device="cuda", generator=gen).to(bf16) for h in (hq, hkv, hkv)]
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    do = torch.randn(B, hq, S, d, device="cuda", generator=gen).to(bf16)
    outs = []
    before = kernels.flash_diffusion.launches_dkv
    for op in ops(MojoSdpa, enable_gqa=True):
        leaves = [t.clone().requires_grad_(True) for t in x]
        y = op(*leaves, mask)
        outs.append((y.detach(), *torch.autograd.grad(y, leaves, do)))
    torch.cuda.synchronize()
    if kernels.flash_diffusion.launches_dkv == before:
        raise AssertionError("kernel O's dk/dv did not launch")
    held(f"sdpa bool mask {hq}/{hkv} S {S} head_dim {d}: o, dq, dk, dv", "O forward, dq and dk/dv launched",
         outs[0], outs[1], bf16)
    # F and G at K 40, H at 16-bit K 36: the golden
    M, K, N = 8, 40, 256
    x8 = torch.randint(-128, 128, (M, K), device="cuda", generator=gen, dtype=torch.int8)
    xs = torch.rand(M, 1, device="cuda", generator=gen)
    for wdt in (torch.int8, "int4"):
        op, gold = ops(MojoQuantGemm, K, N, bf16, True, weight_dtype=wdt, device="cuda")
        w = torch.randint(-8 if wdt == "int4" else -127, 8 if wdt == "int4" else 128, (N, K), device="cuda",
                          generator=gen, dtype=torch.int8)
        ws = torch.rand(N, device="cuda", generator=gen)
        for m in (op, gold):
            m.weight.copy_(pack_int4_rows(w) if wdt == "int4" else w)
            m.weight_scale.copy_(ws)
        counts = (CudaQuantGemm.golden_calls, kernels.int8_matmul.launches, kernels.int4_matmul.launches)
        got = op(x8, xs)
        if (CudaQuantGemm.golden_calls, kernels.int8_matmul.launches, kernels.int4_matmul.launches) != (
                counts[0] + 1, counts[1], counts[2]):
            raise AssertionError(f"CudaQuantGemm ({wdt}) at K {K} must take the golden once and launch nothing")
        held(f"quant gemm {wdt} {M}x{K}x{N}", "golden route (golden_calls + 1, no launch)", got, gold(x8, xs), bf16)
    G, M, K, N = 4, 40, 36, 64
    w = torch.randn(G, K, N, device="cuda", generator=gen).to(bf16)
    op, gold = ops(MojoGroupGemm, w)
    xg = torch.randn(M, K, device="cuda", generator=gen).to(bf16)
    sizes = torch.tensor([10, 0, 25, 5], dtype=torch.int32, device="cuda")
    counts = (CudaGroupGemm.golden_calls, kernels.group_gemm.launches)
    got = op(xg, sizes)
    if (CudaGroupGemm.golden_calls, kernels.group_gemm.launches) != (counts[0] + 1, counts[1]):
        raise AssertionError(f"CudaGroupGemm at 16-bit K {K} must take the golden once and launch nothing")
    held(f"group gemm bf16 G {G} {M}x{K}x{N}", "golden route (golden_calls + 1, no launch)", got, gold(xg, sizes),
         bf16)


def golden_counts() -> dict:
    """``golden_calls`` of every cuda-tier op and Function class, by class name."""
    import importlib
    import inspect
    import pkgutil

    from mojo_opset_tpu_torch.backends.cuda import functions, operators

    counts = {}
    for package in (operators, functions):
        for info in pkgutil.iter_modules(package.__path__):
            module = importlib.import_module(f"{package.__name__}.{info.name}")
            for name, cls in inspect.getmembers(module, inspect.isclass):
                if "golden_calls" in vars(cls):
                    counts[name] = cls.golden_calls
    return counts


def rel_errors(got, want):
    """||got - want|| / ||want|| over the whole tensor and at its worst row of the last dim, ||want|| taken no
    smaller than FLASH_SWA_REL_FLOOR an element; and want's RMS."""
    g, w = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    diff, norm = (g - w).norm(dim=1), w.norm(dim=1)
    floor = FLASH_SWA_REL_FLOOR * w.shape[1] ** 0.5
    whole = (diff.norm() / w.norm().clamp_min(floor * max(w.shape[0], 1) ** 0.5)).item()
    rows = diff / norm.clamp_min(floor)
    rms = w.square().mean().sqrt().item() if w.numel() else 0.0
    return whole, rows.max().item() if rows.numel() else 0.0, rms


def _flash_swa_cases(torch, compare, gen) -> None:
    """J: trainable varlen GQA/SWA flash attention, its three entry points each against its plain version on the
    same inputs (the backward ones fed the plain forward's o and lse, and dk/dv the plain dq's delta), at the
    training shape (main: B 2 x S 2048, 32/8 heads, D 128, causal, one cu vector), then varlen with both windows
    and with a local one, suffix-q (cu_q != cu_k), a zero-length sequence and fully masked rows (their o and dq,
    and the dk and dv of keys no row sees, exactly 0), MHA, group 4 under ABAB, groups 8 and 7 (a ragged 63-row
    tile), D 64 and 256, fp16 and fp32, D 96 and 80 and groups 71/1 and 65 (130/2) held the same way (the padded
    head_dims then shown inert: ``_padding_inert``), dq, dk and dv bit for bit over two runs; and the Wan DiT's
    maskless L = 1560 and its clip's L = 4400 through CudaSdpa against the golden SDPA. bf16/fp16/fp32 outputs to
    their ladder, lse and delta to the fp32 ladder."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import flash_swa as fs
    from mojo_opset_tpu_torch.core.operators import MojoSdpa
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    t_all = time.perf_counter()

    def checker(*dtypes, limits=None):
        """The dtype ladder, then J's relative limits (``limits`` in their place for every output)."""
        def check(got, want):
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            notes = []
            for g, w, dt in zip(got, want, dtypes):
                check_tol_diff(g, w, **tols_for(dt))
                whole, row, rms = rel_errors(g, w)
                limit = limits or FLASH_SWA_REL_LIMITS[_kind(torch, dt)]
                if not (whole <= limit[0] and row <= limit[1]):
                    raise AssertionError(f"flash_swa: relative error {whole:.3g} (worst row {row:.3g}) over "
                                         f"limit {limit} for an output of RMS {rms:.3g}")
                notes.append(f"{tols_for(dt)}, relative {whole:.3g}, worst row {row:.3g} (limit {limit}), "
                             f"rms {rms:.3g}")
            return " / ".join(notes)
        return check

    def case(label, q_lens, kv_lens, hq, hkv, d, dtype, causal=True, lws=None, gws=None, layout="AABB",
             main=False):
        t0 = time.perf_counter()
        cu_q = _cu(torch, q_lens)
        cu_k = cu_q if kv_lens is None else _cu(torch, kv_lens)
        Tq, Tk = sum(q_lens), sum(q_lens if kv_lens is None else kv_lens)
        q, do = (torch.randn(Tq, hq, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(Tk, hkv, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        cfg = dict(causal=causal, local_window=lws, global_window=gws, gqa_layout=layout)
        o, lse = fs.flash_swa_fwd_plain(q, k, v, cu_q, cu_k, **cfg)
        _, delta = fs.flash_swa_dq_plain(q, k, v, o, do, lse, cu_q, cu_k, **cfg)
        rows_seen = torch.zeros(Tq, dtype=torch.bool, device="cuda")
        keys_seen = torch.zeros(Tk, dtype=torch.bool, device="cuda")
        pairs = 0
        for q0, q1, k0, k1, keep in fs.sequence_masks(q, k, cu_q, cu_k, causal, lws, gws):
            pairs += int(keep.sum()) * hq
            rows_seen[q0:q1] |= keep.any(1)
            keys_seen[k0:k1] |= keep.any(0)
        isz = q.element_size()
        rows, kv_rows, stats = Tq * hq * d * isz, Tk * hkv * d * isz, Tq * hq * 4
        kind = _kind(torch, dtype)
        lib_fwd = lib_bwd = None
        if main:  # SDPA on the padded (B, H, S, D) batch: one length, so no padding here
            B, S = len(q_lens), q_lens[0]
            qp, kp, vp, dop = (x.view(B, S, -1, d).transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v, do))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_fwd = lambda: sdpa(qp, kp, vp, is_causal=True, enable_gqa=True)  # noqa: E731
            out = lib_fwd()
            lib_bwd = lambda: torch.autograd.grad(out, (qp, kp, vp), dop, retain_graph=True)  # noqa: E731
            check_tol_diff(out.transpose(1, 2).reshape(o.shape), o, **tols_for(dtype))  # the same function
        t_setup = time.perf_counter() - t0
        name = f"{label} q={q_lens} kv={kv_lens or 'same'} {hq}/{hkv}x{d} {layout} causal={causal} lws={lws} gws={gws}"
        compare("flash_swa_fwd", lambda: fs.flash_swa_fwd(q, k, v, cu_q, cu_k, **cfg),
                lambda: fs.flash_swa_fwd_plain(q, k, v, cu_q, cu_k, **cfg), dtype, "fwd " + name, main,
                check=checker(dtype, f32), bound=(2 * rows + 2 * kv_rows + stats, 4 * d * pairs, kind),
                library=lib_fwd)
        compare("flash_swa_dq", lambda: fs.flash_swa_dq(q, k, v, o, do, lse, cu_q, cu_k, **cfg),
                lambda: fs.flash_swa_dq_plain(q, k, v, o, do, lse, cu_q, cu_k, **cfg), dtype, "dq " + name, main,
                check=checker(dtype, f32), bound=(4 * rows + 2 * kv_rows + 2 * stats, 6 * d * pairs, kind),
                library=lib_bwd, library_graph=False)
        compare("flash_swa_dkv", lambda: fs.flash_swa_dkv(q, k, v, do, lse, delta, cu_q, cu_k, **cfg),
                lambda: fs.flash_swa_dkv_plain(q, k, v, do, lse, delta, cu_q, cu_k, **cfg), dtype, "dkv " + name, main,
                check=checker(dtype, dtype), bound=(2 * rows + 4 * kv_rows + 2 * stats, 8 * d * pairs, kind),
                library=lib_bwd, library_graph=False)
        (o_k, _), (dq_k, _) = fs.flash_swa_fwd(q, k, v, cu_q, cu_k, **cfg), fs.flash_swa_dq(
            q, k, v, o, do, lse, cu_q, cu_k, **cfg)
        dk_k, dv_k = fs.flash_swa_dkv(q, k, v, do, lse, delta, cu_q, cu_k, **cfg)
        (dq_2, _), (dk_2, dv_2) = fs.flash_swa_dq(q, k, v, o, do, lse, cu_q, cu_k, **cfg), fs.flash_swa_dkv(
            q, k, v, do, lse, delta, cu_q, cu_k, **cfg)
        if not (torch.equal(dq_k, dq_2) and torch.equal(dk_k, dk_2) and torch.equal(dv_k, dv_2)):
            raise AssertionError(f"flash_swa: dq, dk or dv differ between two runs ({label})")
        if not (rows_seen.all() and keys_seen.all()):
            blind = [t[~seen].abs().max().item() if (~seen).any() else 0.0
                     for t, seen in ((o_k, rows_seen), (dq_k, rows_seen), (dk_k, keys_seen), (dv_k, keys_seen))]
            if max(blind) != 0.0:
                raise AssertionError(f"flash_swa: rows or keys that see nothing got non-zero o/dq/dk/dv {blind}")
            log("kernel flash_swa", f"{name}: {int((~rows_seen).sum())} rows and {int((~keys_seen).sum())} keys "
                                    f"see nothing; their o, dq, dk, dv are exactly 0")
        log("kernel flash_swa", f"{label}: dq, dk, dv bit for bit over two runs; {time.perf_counter() - t0:.1f} s "
                                f"({t_setup:.1f} s of inputs, plain references and the library's first call)")

    case("training shape", [2048, 2048], None, 32, 8, 128, bf16, main=True)
    case("varlen, both windows", [300, 1, 700, 45], None, 32, 8, 128, bf16, lws=96, gws=32)
    case("varlen, local window", [513, 130], None, 32, 8, 128, f16, lws=128)
    case("suffix-q", [64, 32, 100], [192, 256, 100], 32, 8, 128, bf16)
    case("zero-length, masked rows", [5, 3, 0, 4], [2, 0, 6, 4], 8, 2, 128, f32)
    case("zero-length, window 0", [5, 3, 0, 4], [2, 0, 6, 4], 8, 2, 128, bf16, lws=0)
    case("MHA", [200, 77], None, 8, 8, 128, f32)
    case("group 4 ABAB", [150, 250], None, 16, 4, 128, bf16, layout="ABAB")
    # the group sizes JAX's suite pins (tests/accuracy/operators/test_attention_edges.py:136): 8, and 7, whose 9
    # tokens a block leave a ragged 63-row tile
    case("group 8", [300, 77], None, 16, 2, 128, bf16)
    case("group 7 ABAB", [250, 130], None, 14, 2, 128, f16, lws=64, layout="ABAB")
    case("D 64", [333, 100], None, 8, 2, 64, f16, lws=50)
    case("D 256", [130, 60], None, 4, 2, 256, bf16, causal=False)
    # head_dims the wrappers pad to the next instantiated width; groups over 64 in chunks (a ragged 65 = 64 + 1)
    case("D 96", [300, 77], None, 16, 4, 96, bf16)
    case("D 96 fp32, local window", [130, 60], None, 8, 2, 96, f32, lws=40)
    case("group 71/1", [256, 129], None, 71, 1, 128, bf16)
    case("group 71/1 fp32, D 80", [100, 33], None, 71, 1, 80, f32)
    case("group 65 fp16, D 64", [200, 3], None, 130, 2, 64, f16)
    lens = [300, 77]
    cu = _cu(torch, lens)
    q, do = (torch.randn(sum(lens), 16, 96, device="cuda", generator=gen).to(bf16) for _ in range(2))
    k, v = (torch.randn(sum(lens), 4, 96, device="cuda", generator=gen).to(bf16) for _ in range(2))

    def j_outputs(q, k, v, do, scale):
        o, lse = fs.flash_swa_fwd(q, k, v, cu, cu, scale=scale)
        dq, delta = fs.flash_swa_dq(q, k, v, o, do, lse, cu, cu, scale=scale)
        return (o, dq, *fs.flash_swa_dkv(q, k, v, do, lse, delta, cu, cu, scale=scale))

    _padding_inert(torch, "J at D 96 (o, dq, dk, dv)", lambda: j_outputs(q, k, v, do, None),
                   lambda: j_outputs(*fs.pad_head_dim(128, q, k, v, do), fs._scale(q, None)))
    empty = torch.empty(0, 8, 128, device="cuda", dtype=bf16)
    kv = torch.randn(10, 2, 128, device="cuda", generator=gen).to(bf16)
    before = fs.launches
    o, lse = fs.flash_swa_fwd(empty, kv, kv, _cu(torch, [0]), _cu(torch, [10]))
    if o.shape != empty.shape or fs.launches != before:
        raise AssertionError("flash_swa launched on Tq = 0")
    log("kernel flash_swa", "Tq = 0: no launch, empty output")

    # the Wan DiT's maskless attention (L = 1560 at the (1, 60, 104) latent, 12 heads of 128): CudaSdpa packs it as
    # B equal-length non-causal sequences on J
    dit = [torch.randn(1, 12, 1560, 128, device="cuda", generator=gen).to(bf16) for _ in range(3)]
    cuda_sdpa, golden_sdpa = MojoSdpa.get_backend_impl("cuda")(), MojoSdpa.get_backend_impl("ref")()
    pairs = 12 * 1560 * 1560
    compare("flash_swa_fwd", lambda: cuda_sdpa(*dit), lambda: golden_sdpa(*dit), bf16,
            "Wan DiT SDPA (1, 12, 1560, 128) through CudaSdpa vs the golden", True, key="wan_dit_sdpa",
            check=checker(bf16, limits=SDPA_GOLDEN_REL_LIMITS),
            bound=(4 * dit[0].numel() * 2, 4 * 128 * pairs, "bf16"),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(*dit))
    # the DiT clip's own self-attention (phase 12a: 4400 tokens, 24 heads of 128), the shape that takes most of its step
    clip = [torch.randn(1, 24, 4400, 128, device="cuda", generator=gen).to(bf16) for _ in range(3)]
    pairs = 24 * 4400 * 4400
    compare("flash_swa_fwd", lambda: cuda_sdpa(*clip), lambda: golden_sdpa(*clip), bf16,
            "Wan DiT clip SDPA (1, 24, 4400, 128) through CudaSdpa vs the golden", True, key="wan_dit_clip_sdpa",
            check=checker(bf16, limits=SDPA_GOLDEN_REL_LIMITS),
            bound=(4 * clip[0].numel() * 2, 4 * 128 * pairs, "bf16"),
            library=lambda: torch.nn.functional.scaled_dot_product_attention(*clip))
    del clip
    log("kernel flash_swa", f"J's cases took {time.perf_counter() - t_all:.1f} s")


def _finite_rows(got, want):
    """got and want as rows of the last dim without the rows that are NaN in want, after checking that got is NaN
    on exactly those rows."""
    nan_rows = want.isnan().any(-1)
    if not bool((got.isnan().any(-1) == nan_rows).all()):
        raise AssertionError(f"NaN rows differ: {int(got.isnan().any(-1).sum())} in the kernel's output, "
                             f"{int(nan_rows.sum())} in the plain version's")
    return got[~nan_rows], want[~nan_rows]


def _flash_diffusion_cases(torch, compare, gen) -> None:
    """O: dense attention under a bool keep-mask, its three entry points each against its plain version on the same
    inputs (the backward ones fed the plain forward's o and lse, and dk/dv the plain dq's delta): at the diffusion
    Function's shape (main: B 2 x 16 heads x S 4096, D 128, block_diffusion_mask(4096, 64)) in bf16, fp16 and fp32
    (S 2048), SDAR-30B-A3B's GQA (32/4 heads, S 2048), a random mask with empty rows, a full (B, H, Sq, Sk) mask
    with Sq != Sk and empty rows NaN (CudaSdpa's semantics), odd S 1000 at D 64 and 256, and the Wan DiT's
    key-padding mask (B 2, 24 heads, S 4400, lens 4400 and 880), D 96 (bf16, fp32) and 80 (fp16), whose padding
    is then shown inert (``_padding_inert``). Each output to its ladder and, relative to its size, to
    FLASH_DIFFUSION_REL_LIMITS; an empty row's o is exactly 0 (or NaN) and its dq 0, a key no row keeps
    gets dk = dv = 0, and dq, dk, dv repeat bit for bit."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import flash_diffusion as fd
    from mojo_opset_tpu_torch.backends.cuda.kernels.flash_swa import pad_head_dim
    from mojo_opset_tpu_torch.experimental.functions import block_diffusion_mask
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    t_all = time.perf_counter()

    def checker(*dtypes):
        def check(got, want):
            notes = []
            for g, w, dt in zip(got, want, dtypes):
                check_tol_diff(g, w, **tols_for(dt))
                sentinel = w == fd.EMPTY_LSE  # lse of the rows the mask empties: equal, then out of the norms
                if not torch.equal(g == fd.EMPTY_LSE, sentinel):
                    raise AssertionError("flash_diffusion: the empty rows' lse sentinel differs")
                whole, row, rms = rel_errors(*_finite_rows(g.masked_fill(sentinel, 0), w.masked_fill(sentinel, 0)))
                limit = FLASH_DIFFUSION_REL_LIMITS[_kind(torch, dt)]
                if not (whole <= limit[0] and row <= limit[1]):
                    raise AssertionError(f"flash_diffusion: relative error {whole:.3g} (worst row {row:.3g}) over "
                                         f"limit {limit} for an output of RMS {rms:.3g}")
                notes.append(f"relative {whole:.3g}, worst row {row:.3g} (limit {limit}), rms {rms:.3g}")
            return " / ".join(notes)
        return check

    def case(label, B, hq, hkv, Sq, Sk, d, dtype, mask, empty=0.0, main=False, key=None):
        t0 = time.perf_counter()
        q, do = (torch.randn(B, hq, Sq, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        k, v = (torch.randn(B, hkv, Sk, d, device="cuda", generator=gen).to(dtype) for _ in range(2))
        o, lse = fd.flash_diffusion_fwd_plain(q, k, v, mask, None, empty)
        _, delta = fd.flash_diffusion_dq_plain(q, k, v, o, do, lse, mask)
        keep = fd.keep_mask(mask, q, k)
        pairs = int(keep.sum())  # kept (row, key) pairs over every query head
        rows_seen = keep.any(-1)
        keys_seen = keep.any(2).reshape(B, hkv, hq // hkv, Sk).any(2)
        isz = q.element_size()
        qb, kvb, stats = q.numel() * isz, k.numel() * isz, q.numel() // d * 4
        kind = _kind(torch, dtype)
        lib_fwd = lib_bwd = None
        if main:
            qp, kp, vp = (x.detach().requires_grad_(True) for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_fwd = lambda: sdpa(qp, kp, vp, attn_mask=mask, enable_gqa=hq != hkv)  # noqa: E731
            out = lib_fwd()
            lib_bwd = lambda: torch.autograd.grad(out, (qp, kp, vp), do, retain_graph=True)  # noqa: E731
            check_tol_diff(out, o, **tols_for(dtype))  # the same function
        t_setup = time.perf_counter() - t0
        name = f"{label} B {B} {hq}/{hkv} heads Sq {Sq} Sk {Sk} D {d} mask {tuple(mask.shape)} empty={empty}"
        mask_bytes = mask.numel()
        compare("flash_diffusion_fwd", lambda: fd.flash_diffusion_fwd(q, k, v, mask, None, empty),
                lambda: fd.flash_diffusion_fwd_plain(q, k, v, mask, None, empty), dtype, "fwd " + name, main, key=key,
                check=checker(dtype, f32), bound=(2 * qb + 2 * kvb + stats + mask_bytes, 4 * d * pairs, kind),
                library=lib_fwd)
        compare("flash_diffusion_dq", lambda: fd.flash_diffusion_dq(q, k, v, o, do, lse, mask),
                lambda: fd.flash_diffusion_dq_plain(q, k, v, o, do, lse, mask), dtype, "dq " + name, main, key=key,
                check=checker(dtype, f32), bound=(4 * qb + 2 * kvb + 2 * stats + mask_bytes, 6 * d * pairs, kind),
                library=lib_bwd, library_graph=False)
        compare("flash_diffusion_dkv", lambda: fd.flash_diffusion_dkv(q, k, v, do, lse, delta, mask),
                lambda: fd.flash_diffusion_dkv_plain(q, k, v, do, lse, delta, mask), dtype, "dkv " + name, main,
                key=key, check=checker(dtype, dtype),
                bound=(2 * qb + 4 * kvb + 2 * stats + mask_bytes, 8 * d * pairs, kind), library=lib_bwd,
                library_graph=False)
        (o_k, _), (dq_k, _) = fd.flash_diffusion_fwd(q, k, v, mask, None, empty), fd.flash_diffusion_dq(
            q, k, v, o, do, lse, mask)
        dk_k, dv_k = fd.flash_diffusion_dkv(q, k, v, do, lse, delta, mask)
        (dq_2, _), (dk_2, dv_2) = fd.flash_diffusion_dq(q, k, v, o, do, lse, mask), fd.flash_diffusion_dkv(
            q, k, v, do, lse, delta, mask)
        if not (torch.equal(dq_k, dq_2) and torch.equal(dk_k, dk_2) and torch.equal(dv_k, dv_2)):
            raise AssertionError(f"flash_diffusion: dq, dk or dv differ between two runs ({label})")
        if not (rows_seen.all() and keys_seen.all()):
            o_empty = o_k[~rows_seen]
            o_ok = bool(o_empty.isnan().all()) if empty != empty else bool((o_empty == empty).all())
            blind = [dq_k[~rows_seen].abs().max().item() if (~rows_seen).any() else 0.0,
                     dk_k[~keys_seen].abs().max().item() if (~keys_seen).any() else 0.0,
                     dv_k[~keys_seen].abs().max().item() if (~keys_seen).any() else 0.0]
            if not o_ok or max(blind) != 0.0:
                raise AssertionError(f"flash_diffusion: empty rows' o is not {empty} or dq/dk/dv of rows and keys "
                                     f"the mask empties are not 0: {blind}")
            log("kernel flash_diffusion", f"{name}: {int((~rows_seen).sum())} rows and {int((~keys_seen).sum())} "
                                          f"keys kept nothing; their o is {empty}, their dq, dk, dv exactly 0")
        log("kernel flash_diffusion", f"{label}: dq, dk, dv bit for bit over two runs; {pairs} kept pairs; "
                                      f"{time.perf_counter() - t0:.1f} s ({t_setup:.1f} s of inputs, plain "
                                      f"references and the library's first call)")

    S, blk = DIFFUSION_S, DIFFUSION_BLOCK
    block = block_diffusion_mask(S, blk, device="cuda")
    case("Function shape", DIFFUSION_B, DIFFUSION_H, DIFFUSION_H, S, S, DIFFUSION_D, bf16, block, main=True)
    case("Function shape fp16", DIFFUSION_B, DIFFUSION_H, DIFFUSION_H, S, S, DIFFUSION_D, f16, block)
    case("Function shape fp32, S 2048", DIFFUSION_B, DIFFUSION_H, DIFFUSION_H, S // 2, S // 2, DIFFUSION_D, f32,
         block_diffusion_mask(S // 2, blk, device="cuda"))
    case("SDAR-30B-A3B GQA", DIFFUSION_B, SDAR_HQ, SDAR_HKV, SDAR_S, SDAR_S, 128, bf16,
         block_diffusion_mask(SDAR_S, blk, device="cuda"), main=True, key="sdar_gqa")
    rand = (torch.rand(1000, 1000, device="cuda", generator=gen) < 0.3) | torch.eye(1000, dtype=torch.bool,
                                                                                     device="cuda")
    rand[300:340] = False
    case("random mask, 40 empty rows", 1, 8, 2, 1000, 1000, 128, bf16, rand)
    full = torch.rand(2, 4, 333, 517, device="cuda", generator=gen) < 0.2
    full[1, 2, 7:19] = False
    full[0, :, :, 500:] = False
    case("full mask, Sq != Sk, empty rows NaN", 2, 4, 2, 333, 517, 128, f32, full, empty=float("nan"))
    odd = block_diffusion_mask(1000, 37, device="cuda")
    case("odd S, D 64", 2, 4, 2, 1000, 1000, 64, f16, odd)
    case("odd S, D 256", 1, 4, 4, 1000, 1000, 256, bf16, odd)
    # head_dims the wrappers pad to the next instantiated width
    causal = torch.ones(200, 200, dtype=torch.bool, device="cuda").tril()
    case("causal, D 96", 2, 8, 2, 200, 200, 96, bf16, causal)
    case("odd S, D 96 fp32", 1, 4, 2, 333, 333, 96, f32, block_diffusion_mask(333, 37, device="cuda"))
    case("D 80 fp16", 1, 4, 4, 300, 300, 80, f16, block_diffusion_mask(300, blk, device="cuda"))
    q, do = (torch.randn(2, 8, 200, 96, device="cuda", generator=gen).to(bf16) for _ in range(2))
    k, v = (torch.randn(2, 2, 200, 96, device="cuda", generator=gen).to(bf16) for _ in range(2))

    def o_outputs(q, k, v, do, scale):
        o, lse = fd.flash_diffusion_fwd(q, k, v, causal, scale)
        dq, delta = fd.flash_diffusion_dq(q, k, v, o, do, lse, causal, scale)
        return (o, dq, *fd.flash_diffusion_dkv(q, k, v, do, lse, delta, causal, scale))

    _padding_inert(torch, "O at D 96 (o, dq, dk, dv)", lambda: o_outputs(q, k, v, do, None),
                   lambda: o_outputs(*pad_head_dim(128, q, k, v, do), fd._scale(q, None)))
    lens = torch.tensor([4400, 880], device="cuda")
    pad = (torch.arange(4400, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    case("Wan DiT key padding", 2, 24, 24, 4400, 4400, 128, bf16, pad, empty=float("nan"), main=True,
         key="wan_dit_key_padding")
    log("kernel flash_diffusion", f"O's cases took {time.perf_counter() - t_all:.1f} s")


def _train_kernel_cases(torch, compare, gen) -> None:
    """K, L and M, each against its plain version on the same inputs: at the training step's shapes in bf16 (main:
    timed from a CUDA graph beside the bound, the plain version and, for K and L, a library call; K's with its
    route, grid, registers and blocks an SM), in fp16 and fp32 at one shape, and on edge cases (K's register route
    at row counts that fill no whole group or round and at 5120; widths and pointers that take K's generic kernels:
    no vector loads, short and long rows, a width whose dw sums need more than 48 KB of shared memory; no rows). Every output to the dtype ladder and to
    TRAIN_KERNEL_REL_LIMITS; K's dx and dw run twice and compared bit for bit. M runs forward and backward (sin
    negated) on the head-first contract, the training forward's token-first (B, S, H, D) tensors as a transposed
    view (its output must come back token-first) and (T, H, D) rows."""
    from mojo_opset_tpu_torch.backends.cuda import build
    from mojo_opset_tpu_torch.backends.cuda.functions.position_embedding import rotate_layout
    from mojo_opset_tpu_torch.backends.cuda.kernels import rmsnorm_vjp as kv
    from mojo_opset_tpu_torch.backends.cuda.kernels import rope_head_first as rh
    from mojo_opset_tpu_torch.backends.cuda.kernels import silu_vjp as sv

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    eps, hidden, inter, H, Hkv, D = 1e-6, 2560, 9728, 32, 8, 128
    t_all = time.perf_counter()

    def checker(*dtypes):
        return _rel_checker(torch, TRAIN_KERNEL_REL_LIMITS, *dtypes)

    def rand(*shape, dtype, offset=0):
        """Unit-normal values of ``dtype``; ``offset`` elements into a flat buffer, so the data is not 16-byte
        aligned."""
        n = int(np.prod(shape))
        return torch.randn(n + offset, device="cuda", generator=gen).to(dtype)[offset:].view(shape)

    # K: the step's norms (the two layer norms and the final norm at (4096, 2560), the q norm at (131072, 128), the
    # k norm at (32768, 128)), then fp16/fp32 and edge cases
    t0 = time.perf_counter()
    k_cases = [((TRAIN_TOKENS, hidden), bf16, True, 0), ((TRAIN_TOKENS * H, D), bf16, True, 0),
               ((TRAIN_TOKENS * Hkv, D), bf16, True, 0), ((TRAIN_TOKENS, hidden), f16, False, 0),
               ((TRAIN_TOKENS, hidden), f32, False, 0), ((TRAIN_TOKENS + 1, hidden), bf16, False, 0),
               ((13, hidden), bf16, False, 0), ((1, D), bf16, False, 0), ((5, 5120), bf16, False, 0),
               ((TRAIN_TOKENS, hidden), bf16, False, 1), ((37, 128), bf16, False, 1), ((9, 96), bf16, False, 0),
               ((5, 33), f32, False, 0),
               ((9, 256), bf16, False, 0), ((2, 257), bf16, False, 0), ((3, 300), f16, False, 0),
               ((7, 7168), bf16, False, 0), ((3, 16384), f32, False, 0), ((6, 5120), bf16, False, 1)]
    routes = {}
    for (rows, d), dtype, main, offset in k_cases:
        x, dy = rand(rows, d, dtype=dtype, offset=offset), rand(rows, d, dtype=dtype)
        w = torch.rand(d, device="cuda", generator=gen) + 0.5
        layout = kv.layout(x, dy, w)
        route = f"register route {layout}" if layout else "generic kernels"
        routes[route] = routes.get(route, 0) + 1
        lib = None
        if main:  # the backward of F.rms_norm, its forward outside the timed window
            xg, wg = x.detach().requires_grad_(True), w.to(dtype).requires_grad_(True)
            y = torch.nn.functional.rms_norm(xg, (d,), wg, eps)
            lib = lambda y=y, xg=xg, wg=wg, dy=dy: torch.autograd.grad(y, (xg, wg), dy, retain_graph=True)  # noqa: E731
        n = rows * d
        note = None
        if main:
            tpr, vpt = layout or (0, 0)
            vec = int(d % (4 if d <= kv.SHORT_MAX_D else 16 // x.element_size()) == 0 and not offset)
            res = build.resources("mojo_rmsnorm_bwd_resources", d, vec, tpr, vpt, build.dtype_code(x))
            note = (f"{route}, {kv.grid_blocks(rows, d, dtype, layout, build.sm_count(x.device))} blocks, "
                    f"{res['regs']} registers a thread, {res['blocks_per_sm']} blocks an SM, {res['spill_bytes']} "
                    f"spill bytes")
        compare("rmsnorm_vjp", lambda: kv.rmsnorm_bwd(x, w, dy, eps), lambda: kv.rmsnorm_bwd_plain(x, w, dy, eps),
                dtype, f"rmsnorm_bwd ({rows}, {d}){' unaligned' if offset else ''} on the {route}", main,
                key=f"{rows}x{d}", check=checker(dtype, f32), bound=(3 * n * x.element_size() + 8 * d, 11 * n, "fp32"),
                library=lib, library_graph=False, note=note)
        runs = [kv.rmsnorm_bwd(x, w, dy, eps) for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"rmsnorm_bwd ({rows}, {d}): two runs on the same inputs differ")
    log("kernel rmsnorm_vjp", f"every case's dx and dw equal bit for bit over two runs; cases by route {routes}")
    if len(routes) < 2:
        raise AssertionError(f"K's cases took one route only: {routes}")
    x = torch.empty(0, D, device="cuda", dtype=bf16)
    before = kv.launches
    dx, dw = kv.rmsnorm_bwd(x, torch.ones(D, device="cuda"), x, eps)
    if dx.shape != x.shape or bool(dw.any()) or kv.launches != before:
        raise AssertionError("rmsnorm_bwd launched on no rows, or its dw is not 0")
    log("kernel rmsnorm_vjp", f"no rows: no launch, dw = 0; K's cases took {time.perf_counter() - t0:.1f} s")

    # L: the step's MLP activation (4096, 9728), forward and backward, then fp16/fp32 and unaligned runs
    t0 = time.perf_counter()
    for shape, dtype, main, offset in (((TRAIN_TOKENS, inter), bf16, True, 0), ((TRAIN_TOKENS, inter), f16, False, 0),
                                       ((TRAIN_TOKENS, inter), f32, False, 0), ((1001,), bf16, False, 1),
                                       ((3, 5), f32, False, 0), ((77, 129), f16, False, 3)):
        x, dy = rand(*shape, dtype=dtype, offset=offset), rand(*shape, dtype=dtype)
        n, isz = x.numel(), x.element_size()
        case = f"{tuple(shape)}{' unaligned' if offset else ''}"
        compare("silu_fwd", lambda: sv.silu_fwd(x), lambda: sv.silu_fwd_plain(x), dtype, f"silu forward {case}",
                main, check=checker(dtype), bound=(2 * n * isz, 4 * n, "fp32"),
                library=lambda: torch.nn.functional.silu(x))
        compare("silu_bwd", lambda: sv.silu_bwd(x, dy), lambda: sv.silu_bwd_plain(x, dy), dtype,
                f"silu backward {case}", main, check=checker(dtype), bound=(3 * n * isz, 8 * n, "fp32"),
                library=lambda: torch.ops.aten.silu_backward(dy, x))
    log("kernel silu", f"L's cases took {time.perf_counter() - t0:.1f} s")

    # M: q (2, 32, 2048, 128) and k (2, 8, 2048, 128) in the three layouts, forward and backward
    t0 = time.perf_counter()
    B, S = 2, TRAIN_TOKENS // 2

    def tables(s, d, dtype, batch=None):
        ang = torch.arange(s, device="cuda", dtype=f32)[:, None] * (
            1.0 / 1e6 ** (torch.arange(0, d, 2, device="cuda") / d))
        emb = torch.cat([ang, ang], -1)
        cos, sin = emb.cos(), emb.sin()
        if batch is not None:
            cos, sin = cos.expand(batch, s, d).contiguous(), sin.expand(batch, s, d).contiguous()
        return cos.to(dtype), sin.to(dtype)

    def m_case(label, q, k, cos, sin, head_first, dtype, main=False, key=None, dense=True):
        elems = q.numel() + k.numel()
        bound = (2 * elems * q.element_size() + 2 * cos.numel() * cos.element_size(), 3 * elems, "fp32")
        for direction, negate in (("forward", False), ("backward", True)):
            compare("rope_head_first",
                    lambda negate=negate: rotate_layout(rh.rope_head_first, q, k, cos, sin, head_first, negate),
                    lambda negate=negate: rotate_layout(rh.rope_head_first_plain, q, k, cos, sin, head_first, negate),
                    dtype, f"rope {label} {direction}", main, key=key and f"{key}_{direction}",
                    check=checker(dtype, dtype), bound=bound)
        q_out, _ = rotate_layout(rh.rope_head_first, q, k, cos, sin, head_first)
        if dense and q_out.stride() != q.stride():  # a dense view's output is laid out like it
            raise AssertionError(f"rope {label}: output strides {q_out.stride()} are not the input's {q.stride()}")

    for dtype, main in ((bf16, True), (f16, False), (f32, False)):
        q, k = rand(B, S, H, D, dtype=dtype), rand(B, S, Hkv, D, dtype=dtype)
        m_case("token-first (B, S, H, D) as a transposed view, (B, S, D) tables", q, k, *tables(S, D, dtype, B), False,
               dtype, main, "token_first_view")
    q, k = rand(B, H, S, D, dtype=bf16), rand(B, Hkv, S, D, dtype=bf16)
    m_case("head-first (B, H, S, D), (S, D) fp32 tables", q, k, *tables(S, D, f32), True, bf16, True, "head_first")
    q, k = rand(B * S, H, D, dtype=bf16), rand(B * S, Hkv, D, dtype=bf16)
    m_case("(T, H, D) rows, (T, D) tables", q, k, *tables(B * S, D, bf16), False, bf16, True, "t_rows")
    # edge cases: unaligned data (no vector loads), D 64 and 6, fp32 tables with fp16 rows, a view strided on S
    q, k = rand(2, 3, 5, D, dtype=bf16, offset=1), rand(2, 1, 5, D, dtype=bf16)
    m_case("head-first unaligned", q, k, *tables(5, D, bf16), True, bf16)
    q, k = rand(3, 17, 4, 64, dtype=f16), rand(3, 17, 2, 64, dtype=f16)
    m_case("token-first D 64, fp32 tables", q, k, *tables(17, 64, f32, 3), False, f16)
    q, k = rand(1, 2, 9, 6, dtype=f32), rand(1, 1, 9, 6, dtype=f32)
    m_case("head-first D 6", q, k, *tables(9, 6, f32), True, f32)
    q, k = rand(2, 4, 40, D, dtype=bf16)[:, :, ::2], rand(2, 2, 20, D, dtype=bf16)
    m_case("head-first, a view strided on S", q, k, *tables(20, D, bf16), True, bf16, dense=False)
    log("kernel rope_head_first", f"M's cases took {time.perf_counter() - t0:.1f} s; K, L and M "
                                  f"{time.perf_counter() - t_all:.1f} s")


def flce_rel_errors(got, want):
    """||got - want|| / ||want|| over the whole tensor and at its worst row of the last dim, rows where want is 0
    held to exactly 0 (kernel N's outputs span many magnitudes, so no absolute floor); and want's RMS."""
    g, w = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    diff, norm = (g - w).norm(dim=1), w.norm(dim=1)
    zero = norm == 0
    if bool((diff[zero] != 0).any()):
        raise AssertionError(f"{int((diff[zero] != 0).sum())} rows that are 0 in the plain version are not 0")
    whole = (diff.norm() / w.norm()).item() if bool((~zero).any()) else 0.0
    row = (diff[~zero] / norm[~zero]).max().item() if bool((~zero).any()) else 0.0
    return whole, row, w.square().mean().sqrt().item() if w.numel() else 0.0


def _flce_cases(torch, compare, gen, record) -> None:
    """N: fused linear + cross-entropy, each entry point against its plain version: at the train step's lm_head
    (main: N 4096 x H 2560 x V 151936 bf16, targets drawn over V with a quarter ignored, a and c of the mean
    reduction; timed from a CUDA graph beside the bound and the cuBLAS time of the same product), then fp16 and
    fp32, every option of JAX's test matrix (softcap, label smoothing, z-loss, sum), ragged N and V (V not a
    multiple of 8: dz's row pitch is padded), every row ignored, one row, and flce_backward's chunked-dz route
    forced by a small budget (dw added over 4 runs in fp32) against the plain backward. Every output to its dtype
    ladder and, relative to its size (whole tensor, worst row), to FLCE_REL_LIMITS; dz, dx and dw run twice and
    compare bit for bit."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import flce
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    t_all = time.perf_counter()

    def checker(*dtypes):
        def check(got, want):
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            notes = []
            for g, w, dt in zip(got, want, dtypes):
                check_tol_diff(g, w, **tols_for(dt))
                whole, row, rms = flce_rel_errors(g, w)
                limit = FLCE_REL_LIMITS[_kind(torch, dt)]
                if not (whole <= limit[0] and row <= limit[1]):
                    raise AssertionError(f"flce: relative error {whole:.3g} (worst row {row:.3g}) over limit {limit} "
                                         f"for an output of RMS {rms:.3g}")
                notes.append(f"relative {whole:.3g}, worst row {row:.3g} (limit {limit}), rms {rms:.3g}")
            return " / ".join(notes)
        return check

    def inputs(n, h, v, dtype, ignore_frac=0.25, cfg=None):
        cfg = dict(cfg or {})
        x = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(v, h, device="cuda", generator=gen) * 0.02).to(dtype)
        t = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
        t[torch.rand(n, device="cuda", generator=gen) < ignore_frac] = -100
        lse, _, _ = flce.flce_stats_plain(x, w, t, cfg.get("softcap"))
        a, c = flce.backward_coefficients(torch.ones((), device="cuda"), torch.zeros((), device="cuda"), lse, t,
                                          -100, cfg.get("lse_square_scale", 0.0), cfg.get("reduction", "mean"))
        return x, w, t, lse, a, c

    def case(label, n, h, v, dtype, cfg=None, ignore_frac=0.25, main=False, budget=None):
        cfg = dict(cfg or {})
        cap, ls = cfg.get("softcap"), cfg.get("label_smoothing", 0.0)
        x, w, t, lse, a, c = inputs(n, h, v, dtype, ignore_frac, cfg)
        isz, kind, ops = x.element_size(), _kind(torch, dtype), 2 * n * h * v
        in_bytes = (n * h + v * h) * isz
        name = f"{label} N={n} H={h} V={v} {cfg or ''}"
        dz_buf = flce._dz_buffer(n, v, x)
        dw_out = torch.empty_like(w)
        lib = (lambda: x @ w.t()) if main else None  # noqa: E731
        compare("flce_stats", lambda: flce.flce_stats(x, w, t, cap), lambda: flce.flce_stats_plain(x, w, t, cap),
                dtype, "stats " + name, main, check=checker(f32, f32, f32),
                bound=(in_bytes + 4 * n + 12 * n, ops, kind), library=lib, library_graph=False)
        compare("flce_dz", lambda: flce._dz_kernel(x, w, t, lse, a, c, cap or 0.0, ls, 0, n, dz_buf),
                lambda: flce.flce_dz_plain(x, w, t, lse, a, c, cap, ls), dtype, "dz " + name, main,
                check=checker(dtype), bound=(in_bytes + 16 * n + n * v * isz, ops, kind), library=lib,
                library_graph=False)
        dz = flce.flce_dz(x, w, t, lse, a, c, cap, ls)
        compare("flce_dx", lambda: flce.flce_dx(dz, w), lambda: flce.flce_dx_plain(dz, w), dtype, "dx " + name, main,
                check=checker(dtype), bound=(n * v * isz + v * h * isz + n * h * isz, ops, kind),
                library=(lambda: dz @ w) if main else None, library_graph=False)
        compare("flce_dw", lambda: flce._dw_kernel(dz, x, dw_out, None, 0) or dw_out,
                lambda: flce.flce_dw_plain(dz, x), dtype, "dw " + name, main, check=checker(dtype),
                bound=(n * v * isz + n * h * isz + v * h * isz, ops, kind),
                library=(lambda: dz.t() @ x) if main else None, library_graph=False)
        runs = [(flce.flce_dz(x, w, t, lse, a, c, cap, ls), flce.flce_dx(dz, w), flce.flce_dw(dz, x)) for _ in range(2)]
        if not all(torch.equal(p, q) for p, q in zip(*runs)):
            raise AssertionError(f"flce {name}: two runs of dz, dx, dw on the same inputs differ")
        if budget is not None:
            rows = flce.run_rows(n, v, isz, budget)
            compare("flce_dw", lambda: flce.flce_backward(x, w, t, lse, a, c, cap, ls, dz_budget=budget),
                    lambda: flce.flce_backward_plain(x, w, t, lse, a, c, cap, ls), dtype,
                    f"backward in {-(-n // rows)} dz runs of {rows} rows " + name, False, check=checker(dtype, dtype))
            again = [flce.flce_backward(x, w, t, lse, a, c, cap, ls, dz_budget=budget) for _ in range(2)]
            if not all(torch.equal(p, q) for p, q in zip(*again)):
                raise AssertionError(f"flce {name}: two chunked backward runs differ")

    t0 = time.perf_counter()
    case("train step lm_head", TRAIN_TOKENS, 2560, 151936, bf16, main=True)
    ops = 2 * TRAIN_TOKENS * 2560 * 151936
    rates = ", ".join(f"{name[5:]} {ops / record[name]['ms'] / 1e9:.1f}; {ops / record[name]['library_ms'] / 1e9:.1f}"
                      for name in ("flce_stats", "flce_dz", "flce_dx", "flce_dw"))
    log("kernel flce", f"at the step's lm_head, TFLOP/s of each product (kernel; one cuBLAS matmul): {rates}; main "
                       f"cases took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    case("fp16", 300, 256, 1000, f16)
    case("fp32", 300, 256, 1000, f32)
    for cfg in FLCE_CONFIGS:
        case("option", 300, 256, 1003, bf16, cfg)
    case("ragged N and V", 333, 136, 5003, bf16, dict(label_smoothing=0.1))
    case("every row ignored", 200, 256, 1000, bf16, ignore_frac=1.1)
    case("one row", 1, 64, 130, f32, ignore_frac=0.0)
    case("chunked dz", 1000, 512, 6000, bf16, dict(softcap=30.0, label_smoothing=0.05, lse_square_scale=1e-4),
         budget=260 * 6000 * 2)
    case("chunked dz fp32", 700, 128, 3000, f32, budget=200 * 3000 * 4)
    x = torch.zeros(4, 60, device="cuda", dtype=bf16)
    try:
        flce.flce_stats(x, torch.zeros(10, 60, device="cuda", dtype=bf16),
                        torch.zeros(4, device="cuda", dtype=torch.int32))
    except ValueError as e:
        log("kernel flce", f"H = 60 in bf16 refused: {e}")
    else:
        raise AssertionError("flce took H = 60 in bf16 (rows not 16-byte aligned)")
    log("kernel flce", f"every case's dz, dx, dw and chunked backward equal bit for bit over two runs; N's cases "
                       f"took {time.perf_counter() - t_all:.1f} s")


def _layers(model):
    return model.model.layers if hasattr(model, "model") else model.layers


def _build_pair(torch, config, model_cls=None):
    """The kernel-path model (default tier) and a plain-path twin
    (MOJO_BACKEND=ref) bound to the same weight tensors: the twin is built
    on the meta device and takes the model's tensors (a full-width MoE
    model fits the card once, not twice)."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM

    model_cls = model_cls or Qwen3ForCausalLM
    model = model_cls(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    plain = _plain_twin(torch, model, model_cls)
    attn = _layers(model)[0].self_attn
    assert type(attn.attn_decode).__name__.startswith("Cuda"), type(attn.attn_decode)
    assert type(_layers(plain)[0].self_attn.attn_decode).__name__.startswith("Ref")
    mlp = _layers(model)[0].mlp
    if hasattr(mlp, "experts"):
        assert type(mlp.experts).__name__ == "CudaExperts", type(mlp.experts)
        assert type(_layers(plain)[0].mlp.experts).__name__ == "RefExperts"
    return model, plain


def _plain_twin(torch, model, model_cls):
    """A plain twin (MOJO_BACKEND=ref) of ``model`` built on the meta device
    and bound to its tensors."""
    with plain_tier():
        plain = model_cls(model._config, device="meta")
    _bind(plain, model)
    return plain


def _bind(plain, model) -> None:
    """Give ``plain`` (built on the meta device) ``model``'s tensors: its state
    and the buffers outside the state dict (the rotary table)."""
    plain.load_state_dict(model.state_dict(), assign=True)
    for name, buf in model.named_buffers():
        module_name, _, attr = name.rpartition(".")
        setattr(plain.get_submodule(module_name), attr, buf)
    assert all(p.device.type == "cuda" for p in plain.parameters()) and all(
        b.device.type == "cuda" for b in plain.buffers())


@contextlib.contextmanager
def plain_tier():
    """Ops constructed inside take the golden tier (MOJO_BACKEND=ref)."""
    os.environ["MOJO_BACKEND"] = "ref"
    try:
        yield
    finally:
        del os.environ["MOJO_BACKEND"]


def _quantized_pair(torch, source, quant_kv: bool, weight_dtype: str = "int8"):
    """w8a8 (or, with ``weight_dtype="int4"``, w4a8) twins of ``source`` on
    the kernel path and on the plain path: the same weights, quantized on
    the card."""
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize_qwen3

    model = quantize_qwen3(source, weight_dtype, quant_kv=quant_kv)
    with plain_tier():
        plain = quantize_qwen3(source, weight_dtype, quant_kv=quant_kv)
    layer = model.model.layers[0]
    assert type(layer.input_layernorm).__name__ == "CudaRMSNormQuant", type(layer.input_layernorm)
    assert type(layer.mlp.down_proj).__name__ == "CudaQuantGemm"
    assert (layer.mlp.down_proj.weight_dtype == "int4") == (weight_dtype == "int4")
    assert type(plain.model.layers[0].mlp.down_proj).__name__ == "RefQuantGemm"
    for a, b in zip(model.state_dict().values(), plain.state_dict().values()):
        assert torch.equal(a, b)
    return model, plain


def _prompts(vocab: int, lens) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(0)
    return rng.integers(1, vocab, int(sum(lens))).astype(np.int32), np.asarray(lens, np.int32)


def _greedy_match(torch, name, model, plain, ids, lens, tie_bound=None, session_cls=None) -> None:
    """16 greedy steps: kernel path == plain path == fused window.

    With ``tie_bound`` (the quantized twins whose activations are int8), the
    kernel and plain paths may part at one step of one row, if there the
    two paths' logits differ by at most ``tie_bound`` and the plain path's
    two best logits lie closer than that difference: a sum in another order
    moved an int8 activation across a rounding tie, and the argmax was a
    near-tie. The fused window must equal the stepwise kernel path."""
    from mojo_opset_tpu_torch.runtime import GeneratorHook, GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    class KeepLogits(GeneratorHook):
        def __init__(self):
            self.steps = []

        def after_prefill(self, *, logits, session):
            self.steps.append(logits)

        def after_decode_step(self, *, step, logits, next_token_id):
            self.steps.append(logits)

    def generate(m, fused=False, hook=None):
        gm = PagedAttentionGenerationModel(m, block_size=16, **({"session_cls": session_cls} if session_cls else {}))
        gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=16, hooks=[hook] if hook else None)
        return gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused)

    kept, plain_kept = KeepLogits(), KeepLogits()
    tokens, plain_tokens = generate(model, hook=kept), generate(plain, hook=plain_kept)
    fused = generate(model, fused=True)
    log(name, f"kernel tokens {tokens.tolist()}")
    if not np.array_equal(tokens, fused):
        raise AssertionError(f"{name}: fused tokens differ from stepwise: {fused.tolist()} vs {tokens.tolist()}")
    if np.array_equal(tokens, plain_tokens):
        log(name, "16 greedy steps: kernel path == plain path == fused window")
        return
    parted = np.argwhere(tokens != plain_tokens)  # (row, step) pairs
    row, step = (int(i) for i in parted[np.argmin(parted[:, 1])])
    k_row, p_row = kept.steps[step][row].float(), plain_kept.steps[step][row].float()
    delta = (k_row - p_row).abs().max().item()
    top2 = torch.topk(p_row, 2).values
    gap = (top2[0] - top2[1]).item()
    note = (f"kernel and plain paths part at step {step} of row {row}: logits differ by {delta:.4g} there, the "
            f"plain path's top-2 gap is {gap:.4g}")
    if tie_bound is None or delta > tie_bound or gap > delta:
        raise AssertionError(f"{name}: greedy tokens differ: kernel {tokens.tolist()} plain {plain_tokens.tolist()}; "
                             f"{note}")
    log(name, f"16 greedy steps: kernel path == fused window; {note} (a near-tie, bound {tie_bound})")


def _standalone_greedy(model, ids, lens, steps: int) -> np.ndarray:
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=16), None, GreedySampler(),
                        max_new_tokens=steps)
    return gen.generate_from_ids(ids, np.asarray(lens, np.int32), ignore_eos=True)


def _truncated_draft(torch, target, layers: int):
    """A draft of the target's first ``layers`` layers, sharing its
    embedding, norm, rotary table and lm_head (no weights copied)."""
    import dataclasses

    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM

    draft = Qwen3ForCausalLM(dataclasses.replace(target.qwen3_config, num_hidden_layers=layers), device="meta")
    draft.model.embed_tokens = target.model.embed_tokens
    draft.model.layers = torch.nn.ModuleList(target.model.layers[:layers])
    draft.model.norm = target.model.norm
    draft.model.rotary_emb = target.model.rotary_emb
    draft.lm_head = target.lm_head
    return draft


def _speculative_match(torch, target, drafts: dict, ids, lens, steps: int = 24) -> None:
    """Greedy speculative decoding (k = 4), unfused and fused, emits exactly
    the target's vanilla greedy tokens with each draft."""
    from mojo_opset_tpu_torch.runtime import SpeculativeDecoder

    want = _standalone_greedy(target, ids, lens, steps)
    for name, draft in drafts.items():
        spec = SpeculativeDecoder(target, draft, k=4, mode="greedy", block_size=16)
        for run in (spec.generate, spec.generate_fused):
            got = run(ids, lens, max_new_tokens=steps)
            if not np.array_equal(got, want):
                raise AssertionError(f"speculative {run.__name__} with the {name} differs from vanilla greedy: "
                                     f"{got.tolist()} vs {want.tolist()}")
            log("small speculative", f"{name}, {run.__name__}: {steps} tokens x {len(lens)} == vanilla greedy "
                                     f"in {spec.last_rounds} rounds")


def _continuous_match(torch, model, draft) -> None:
    """6 requests on 2 slots, 4 of them behind one shared 128-token prefix:
    the batcher with its prefix cache, and the speculative batcher, give
    each request its standalone greedy tokens."""
    from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator, SpeculativeContinuousBatchingGenerator

    steps, vocab = 16, SMALL["vocab_size"]
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, vocab, 128).astype(np.int32)
    tail = lambda n: rng.integers(1, vocab, n).astype(np.int32)  # noqa: E731
    prompts = [np.concatenate([prefix, tail(5)]), tail(9), np.concatenate([prefix, tail(17)]),
               np.concatenate([prefix, tail(1)]), tail(40), np.concatenate([prefix, tail(30)])]
    want = [_standalone_greedy(model, p, [p.size], steps)[0] for p in prompts]
    batchers = {
        "continuous batcher, prefix cache": ContinuousBatchingGenerator(
            model, batch_slots=2, block_size=16, max_new_tokens=steps, prefix_cache_blocks=16),
        "speculative batcher, w4a8 draft": SpeculativeContinuousBatchingGenerator(
            model, draft, speculative_k=4, batch_slots=2, block_size=16, max_new_tokens=steps),
    }
    for name, gen in batchers.items():
        rids = [gen.submit(p) for p in prompts]
        results = gen.run()
        for rid, w in zip(rids, want):
            if not np.array_equal(results[rid], w):
                raise AssertionError(f"{name}: request {rid} gave {results[rid].tolist()}, standalone {w.tolist()}")
        extra = f"; {gen._prefix_owned} blocks held by the prefix cache" if gen.prefix_cache_blocks else ""
        log("small continuous", f"{name}: {len(prompts)} requests on 2 slots == standalone greedy{extra}")
    if batchers["continuous batcher, prefix cache"]._prefix_owned < 128 // 16:
        raise AssertionError("the shared 128-token prefix never entered the prefix cache")


def _converted_pair(torch, convert, source, *args):
    """A converter's twin of ``source`` on the kernel path and on the plain
    path (MOJO_BACKEND=ref): the same weights, converted on the card."""
    model = convert(source, *args)
    with plain_tier():
        plain = convert(source, *args)
    for a, b in zip(model.state_dict().values(), plain.state_dict().values()):
        assert torch.equal(a, b)
    return model, plain


def _batcher_match(torch, name, model) -> None:
    """4 requests on 2 slots of the continuous batcher: each gets its standalone greedy tokens."""
    from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator

    steps, rng = 12, np.random.default_rng(2)
    prompts = [rng.integers(1, SMALL["vocab_size"], n).astype(np.int32) for n in (9, 33, 2, 20)]
    want = [_standalone_greedy(model, p, [p.size], steps)[0] for p in prompts]
    gen = ContinuousBatchingGenerator(model, batch_slots=2, block_size=16, max_new_tokens=steps)
    rids = [gen.submit(p) for p in prompts]
    results = gen.run()
    for rid, w in zip(rids, want):
        if not np.array_equal(results[rid], w):
            raise AssertionError(f"{name}, continuous batcher: request {rid} gave {results[rid].tolist()}, "
                                 f"standalone {w.tolist()}")
    log("small continuous", f"{name}: {len(prompts)} requests on 2 slots == standalone greedy")


def phase_small_model(torch) -> None:
    from mojo_opset_tpu_torch.modeling.deepseekv3 import (
        DeepseekV3Config, DeepseekV3ForCausalLM, MLARuntimeState, quantize_deepseek_v3,
    )
    from mojo_opset_tpu_torch.modeling.qwen3 import (
        Qwen3Config, Qwen3MoeConfig, Qwen3MoeForCausalLM, quantize_qwen3_moe,
    )
    from mojo_opset_tpu_torch.modeling.seed_oss import SeedOssConfig, SeedOssForCausalLM

    ids, lens = _prompts(SMALL["vocab_size"], (37, 20, 5, 64))
    seed, seed_plain = _build_pair(torch, SeedOssConfig(**SMALL, dtype=torch.float32), SeedOssForCausalLM)
    _greedy_match(torch, "small fp32 Seed-OSS model", seed, seed_plain, ids, lens)
    del seed, seed_plain
    moe, moe_plain = _build_pair(torch, Qwen3MoeConfig(**SMALL_MOE, dtype=torch.float32), Qwen3MoeForCausalLM)
    _greedy_match(torch, "small fp32 MoE model", moe, moe_plain, ids, lens)
    for weight_dtype, name in (("int8", "small w8a8 MoE model"), ("int4", "small w4a8 MoE model")):
        q_moe, q_plain = _converted_pair(torch, quantize_qwen3_moe, moe, weight_dtype)
        assert type(q_moe.layers[0].mlp.experts).__name__ == "CudaQuantExperts", type(q_moe.layers[0].mlp.experts)
        assert type(q_plain.layers[0].mlp.experts).__name__ == "RefQuantExperts"
        _greedy_match(torch, name, q_moe, q_plain, ids, lens, tie_bound=SMALL_TIE_BOUND)
        if weight_dtype == "int8":
            _batcher_match(torch, name, q_moe)
    ds = DeepseekV3ForCausalLM(DeepseekV3Config(**SMALL_DEEPSEEK, dtype=torch.float32), device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(0))
    q_ds, q_ds_plain = _converted_pair(torch, quantize_deepseek_v3, ds)
    assert type(q_ds.model.layers[1].mlp.routed_experts.experts).__name__ == "CudaQuantExperts"
    _greedy_match(torch, "small w8a8 DeepSeek-V3 model", q_ds, q_ds_plain, ids, lens, tie_bound=SMALL_TIE_BOUND,
                  session_cls=MLARuntimeState)
    del moe, moe_plain, q_moe, q_plain, ds, q_ds, q_ds_plain
    model, plain = _build_pair(torch, Qwen3Config(**SMALL, dtype=torch.float32))
    _greedy_match(torch, "small fp32 model", model, plain, ids, lens)
    for quant_kv, name in ((False, "small w8a8 model"), (True, "small w8a8 + C8 model")):
        q_model, q_plain = _quantized_pair(torch, model, quant_kv)
        _greedy_match(torch, name, q_model, q_plain, ids, lens)
    w4a8, w4a8_plain = _quantized_pair(torch, model, False, weight_dtype="int4")
    _greedy_match(torch, "small w4a8 model", w4a8, w4a8_plain, ids, lens, tie_bound=SMALL_TIE_BOUND)
    _speculative_match(torch, model, {"w4a8 draft": w4a8, "1-layer draft": _truncated_draft(torch, model, 1)},
                       ids, lens)
    _continuous_match(torch, model, w4a8)
    del model, plain, q_model, q_plain, w4a8, w4a8_plain
    torch.cuda.empty_cache()


# the kernels whose device time a profiled prefill reports, by the names of their CUDA kernels
# kernel A's row kernels in a profile (the register kernel, and the generic ones it shares with P)
A_KERNEL_NAMES = ("rmsnorm_regs_kernel", "rmsnorm_warp_kernel", "rmsnorm_block_kernel")
PREFILL_FAMILIES = {"D": ("paged_prefill_",), "F": ("int8_gemm_kernel", "int8_wgmma_kernel"),
                    "G": ("int4_decode_kernel", "int4_wgmma_kernel"), "H": ("gmm_",),
                    "R": ("group_quant_gemm_kernel",),
                    "I": ("mla_mma_kernel", "mla_merge_kernel", "mla_fma_kernel"), "B": ("rope_token_first",),
                    "E": ("rmsnorm_quant",)}


def _prefill_profile(torch, tag: str, card: str, gm, ids, lens) -> None:
    """One more prefill of the batch under torch.profiler: its device busy ms, kernel count and the device ms of
    kernels D, F, G, H, I, B and E (the prefill's wall ms is the PerfHook's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm(ids, context_input_len=lens)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    fam = {f: sum(e.self_device_time_total for e in device if any(p in e.key for p in pats)) / 1e3
           for f, pats in PREFILL_FAMILIES.items()}
    log(tag, f"{card}: one prefill ({int(np.sum(lens))} tokens, bs {len(lens)}) profiled: device busy {busy:.3f} ms, "
             f"{sum(e.count for e in device)} kernels; " + ", ".join(f"{f} {ms:.3f} ms" for f, ms in fam.items() if ms))


def _serve_and_check(torch, tag: str, model, plain, ids, lens, path_kernels, card: str, reference=None,
                     cosine_bound: float = 0.999, host_sync_errors: bool = False, step_families=()):
    """Phase 5's run for one model and its plain twin: prefill, DECODE_STEPS
    greedy steps and a FusedDecode window (with ``host_sync_errors`` under
    ``no_host_sync``) with the counters zeroed just before and read just
    after (every kernel of ``path_kernels`` must launch), one more decode
    step counted and profiled (with the device ms and share of busy of each
    PREFILL_FAMILIES kernel named in ``step_families``), and the last-token
    prefill logits against the plain path (per-row cosine >=
    ``cosine_bound``; against ``reference`` printed with no bound). Peak
    memory counts from the caller's last reset. Returns (counts, logits,
    session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.runtime import (
        FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook,
    )

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
    with no_host_sync(torch, model) if host_sync_errors else contextlib.nullcontext():
        window = FusedDecode(model)(session, first, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t_fused) * 1e3 / FUSED_STEPS
    counts = {k: v for k, v in kernels.launch_counts().items() if k in path_kernels}
    log(tag, f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the {tag} path never launched: {counts}")
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    window = window.T.cpu().numpy()
    if not np.array_equal(window, out[:, 1:FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {window.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    if host_sync_errors:
        log(tag, f"FusedDecode window ({FUSED_STEPS} steps) ran with host syncs as errors; == stepwise")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")

    token = torch.as_tensor(window[:, -1], device="cuda")
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = {k: v for k, v in kernels.launch_counts().items() if v}
    torch.cuda.synchronize()
    t = time.perf_counter()
    gm(token, session=session)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm(token, session=session)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    shares = "".join(
        f"; {f} {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)" for f, ms in (
            (f, sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES[f])) / 1e3)
            for f in step_families))
    log(tag, f"{card}: one decode step (bs 4, context ~1050): {sum(e.count for e in device)} device kernels, the "
             f"port's kernels {per_step}; wall {step_ms:.2f} ms unprofiled, device busy {busy:.3f} ms (idle "
             f"{100 * (1 - busy / step_ms):.1f}%){shares}")

    plain_logits, _ = PagedAttentionGenerationModel(plain, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    cos = torch.nn.functional.cosine_similarity(logits, plain_logits, dim=-1)
    note = ""
    if reference is not None:
        ref_cos = torch.nn.functional.cosine_similarity(logits, reference, dim=-1)
        note = f"; vs the bf16 model {[round(c, 4) for c in ref_cos.tolist()]} (no bound: random weights)"
    log(tag, f"last-token logits {tuple(logits.shape)} finite; per-row cosine vs plain path "
             f"{[round(c, 6) for c in cos.tolist()]} (bound {cosine_bound}){note}")
    if cos.min().item() < cosine_bound:
        raise AssertionError(f"{tag} prefill logits disagree with the plain path: cosine {cos.tolist()}")
    rec = hook.records[-1]
    log(tag, f"{card}: prefill {rec['prefill_ms']:.2f} ms ({rec['in_tok']} tokens, bs 4); decode "
             f"{rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise, {rec['decode_steps']} "
             f"steps); FusedDecode {fused_ms:.3f} ms/step, {len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak "
             f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(tag, f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    _prefill_profile(torch, tag, card, gm, ids, lens)
    return counts, logits, session


def phase_full_width(torch, card: str) -> dict:
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config

    config = Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16, kv_layout="NHD")
    t0 = time.perf_counter()
    model, plain = _build_pair(torch, config)
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    log("full width", f"Qwen3-4B geometry, {n_params / 1e9:.2f} B params bf16, built in "
                      f"{time.perf_counter() - t0:.1f} s")
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    counts, _, _ = _serve_and_check(torch, "full width", model, plain, ids, lens, BF16_PATH_KERNELS, card)
    return counts


def phase_int8_full_width(torch, card: str) -> dict:
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

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
    counts, _, session = _serve_and_check(torch, "int8 full width", model, plain, ids, lens, INT8_PATH_KERNELS, card,
                                          reference=bf16_logits)
    key0 = session.caches.key(0)
    if key0.dtype != torch.int8 or session.kv_layout != "HND" or not bool((session.caches.key_scale(0) > 0).all()):
        raise AssertionError(f"the session's cache is not calibrated int8 HND: {key0.dtype} {session.kv_layout}")
    return counts


def _first_divergence(torch, gm, ids, want, got) -> str:
    """Where a speculative stream leaves vanilla greedy, the target's two
    best logits at that position must lie within SPEC_TIE_GAP: the verify
    runs the prefill kernel and vanilla the decode kernel, and bf16 rounds
    differently in each. Returns a note for the log."""
    if np.array_equal(got, want):
        return "equal to vanilla greedy on every token"
    p = int(np.nonzero(got != want)[0][0])
    context = np.concatenate([ids, want[:p]]).astype(np.int32)
    logits, _ = gm(context, context_input_len=np.array([context.size], np.int32))
    top2 = torch.topk(logits[0], 2).values
    gap = float(top2[0] - top2[1])
    note = f"first differs at new token {p} ({want[p]} vs {got[p]}), target's top-2 logit gap there {gap:.4f}"
    if gap > SPEC_TIE_GAP:
        raise AssertionError(f"speculative stream leaves vanilla greedy where the target is not tied: {note}")
    return note + f" (<= {SPEC_TIE_GAP}: a bf16 tie)"


def phase_w4a8_speculative(torch, card: str) -> tuple:
    """bench.py:298-331 on the card: bs 1, a 512-token prompt, 64 new tokens,
    a bf16 Qwen3-4B target and its w4a8 twin as the draft, k = 4. Returns the
    path's launches and G's by route and M."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import (
        GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook, SpeculativeDecoder,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    target = Qwen3ForCausalLM(Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
    draft, plain_draft = _quantized_pair(torch, target, quant_kv=False, weight_dtype="int4")
    int4_bytes = sum(m.weight.numel() for m in draft.modules() if getattr(m, "weight_dtype", None) == "int4")
    int8_bytes = sum(m.weight.numel() for m in draft.modules() if getattr(m, "weight_dtype", None) == torch.int8)
    log("w4a8 speculative", f"bf16 Qwen3-4B target and its w4a8 draft, quantized on the card in "
                            f"{time.perf_counter() - t0:.1f} s: {int4_bytes / 1e9:.3f} GB packed int4 weights, "
                            f"{int8_bytes / 1e9:.3f} GB int8 (the lm_head)")
    ids = np.random.default_rng(0).integers(1, QWEN3_4B["vocab_size"], SPEC_PROMPT).astype(np.int32)
    lens = np.array([SPEC_PROMPT], np.int32)

    draft_gm = PagedAttentionGenerationModel(draft, block_size=BLOCK_SIZE)
    d_logits, _ = draft_gm(ids, context_input_len=lens)
    p_logits, _ = PagedAttentionGenerationModel(plain_draft, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    cos = torch.nn.functional.cosine_similarity(d_logits, p_logits, dim=-1).min().item()
    log("w4a8 speculative", f"draft last-token logits finite: {bool(torch.isfinite(d_logits).all())}; cosine vs "
                            f"its plain path {cos:.6f} (bound 0.999)")
    if cos < 0.999 or not torch.isfinite(d_logits).all():
        raise AssertionError(f"the w4a8 draft's logits disagree with its plain path: cosine {cos}")
    _prefill_profile(torch, "w4a8 speculative draft", card, draft_gm, ids, lens)
    del plain_draft, p_logits, draft_gm
    torch.cuda.empty_cache()

    gm = PagedAttentionGenerationModel(target, block_size=BLOCK_SIZE)
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=SPEC_NEW, hooks=[hook])
    spec = SpeculativeDecoder(target, draft, k=SPEC_K, mode="greedy", block_size=BLOCK_SIZE)
    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up
    spec.generate_fused(ids, lens, max_new_tokens=SPEC_NEW)

    kernels.reset_launch_counts()
    vanilla = gen.generate_from_ids(ids, lens, ignore_eos=True)[0]
    stepwise = hook.records[-1]
    vanilla_fused = gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=True)[0]
    fused = hook.records[-1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    spec_fused = spec.generate_fused(ids, lens, max_new_tokens=SPEC_NEW)[0]
    spec_fused_s, rounds_fused = time.perf_counter() - t, spec.last_rounds
    t = time.perf_counter()
    spec_out = spec.generate(ids, lens, max_new_tokens=SPEC_NEW)[0]
    spec_s, rounds = time.perf_counter() - t, spec.last_rounds
    counts = {k: v for k, v in kernels.launch_counts().items() if k in SPEC_PATH_KERNELS}
    # a tree from before G's routes counts none (benchmark/kernel_ab.py paths runs this phase on the parent's kernels)
    routes = getattr(kernels.int4_matmul, "launches_by_route", None)
    by_route = {f"{name} M={m}": n for (name, m), n in sorted((routes or {}).items())}
    log("w4a8 speculative", f"launches on the path: {counts}; G's by route and M: {by_route}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the speculative path never launched: {counts}")
    if routes is not None and sum(by_route.values()) != counts["int4_matmul"]:
        raise AssertionError(f"G's launches by route {by_route} do not add up to {counts['int4_matmul']}")

    t = time.perf_counter()
    spec.prefill(spec.new_sessions(1), ids, lens)  # both models' prompt, shared by every run above
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    spec_ms, spec_fused_ms = ((s - prefill_s) * 1e3 / SPEC_NEW for s in (spec_s, spec_fused_s))

    if not np.array_equal(vanilla_fused, vanilla):
        raise AssertionError(f"FusedDecode {vanilla_fused.tolist()} differs from stepwise {vanilla.tolist()}")
    for name, got in (("generate_fused", spec_fused), ("generate", spec_out)):
        log("w4a8 speculative", f"{name}: {_first_divergence(torch, gm, ids, vanilla, got)}")
    # each round emits its accepted drafts and one token of the target; the last round may be cut
    accept = (SPEC_NEW - 1 - rounds) / (rounds * SPEC_K)
    log("w4a8 speculative",
        f"{card}: bs 1, prompt {SPEC_PROMPT}, {SPEC_NEW} new tokens, k {SPEC_K}: vanilla "
        f"{stepwise['decode_avg_ms']:.3f} ms/token stepwise, {fused['decode_avg_ms']:.3f} ms/token FusedDecode; "
        f"speculative {spec_fused_ms:.3f} ms/token fused ({rounds_fused} rounds), {spec_ms:.3f} ms/token "
        f"unfused ({rounds} rounds, {(SPEC_NEW - 1) / rounds:.2f} tokens per round, acceptance >= {accept:.3f}); "
        f"speed-up over FusedDecode {fused['decode_avg_ms'] / spec_fused_ms:.2f}x; prefill of both models "
        f"{prefill_s * 1e3:.2f} ms; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del target, draft, spec, gm, gen
    torch.cuda.empty_cache()
    return counts, by_route


@contextlib.contextmanager
def no_host_sync(torch, model):
    """From ``model``'s first call inside the block on, a host sync (``.item()``,
    ``.tolist()``, a copy to the host) raises: the window's own setup copies
    run before that call, its read-back after the block."""
    handle = model.register_forward_pre_hook(lambda *_: torch.cuda.set_sync_debug_mode("error"))
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
        handle.remove()


def _routes(moe_blocks) -> tuple[list, list]:
    """Record the top-k expert indices of every ``MojoMoE`` in ``moe_blocks`` on each call."""
    routes = []
    hooks = [moe.gating.register_forward_hook(lambda mod, inp, out: routes.append(out[0])) for moe in moe_blocks]
    return routes, hooks


def phase_moe_full_width(torch, card: str) -> tuple:
    """Qwen3-30B-A3B at full width and depth, bf16, random weights: the MoE
    path end to end, its experts held to the plain experts, and one decode
    step's device time; then its w8a8 and w4a8 halves (``_moe_quant_halves``).
    Returns (the bf16 path's counts, the quantized paths' counts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeConfig, Qwen3MoeForCausalLM
    from mojo_opset_tpu_torch.runtime import (
        FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook,
    )
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = Qwen3MoeConfig(**QWEN3_30B_A3B, dtype=torch.bfloat16, kv_layout="NHD")
    t0 = time.perf_counter()
    model, plain = _build_pair(torch, config, Qwen3MoeForCausalLM)
    n_params = sum(p.numel() for p in model.parameters())
    log("moe full width", f"Qwen3-30B-A3B geometry, {n_params / 1e9:.2f} B params bf16 ({n_params * 2 / 2**30:.1f} "
                          f"GiB), built in {time.perf_counter() - t0:.1f} s; the plain twin shares its tensors")
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1, hooks=[hook])

    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up
    kernels.reset_launch_counts()
    out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    routes, route_hooks = _routes([layer.mlp for layer in model.layers])
    mlp_in = []
    in_hook = model.layers[MOE_LAYER_CHECKED].mlp.register_forward_pre_hook(lambda mod, args: mlp_in.append(args[0]))
    logits, session = gm(ids, context_input_len=lens)
    in_hook.remove()
    for h in route_hooks:
        h.remove()
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_fused = time.perf_counter()
    with no_host_sync(torch, model):
        window = FusedDecode(model)(session, first, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t_fused) * 1e3 / FUSED_STEPS
    counts = {k: v for k, v in kernels.launch_counts().items() if k in MOE_PATH_KERNELS}
    log("moe full width", f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the MoE path never launched: {counts}")
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    window = window.T.cpu().numpy()
    if not np.array_equal(window, out[:, 1:FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {window.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    log("moe full width", f"FusedDecode window ({FUSED_STEPS} steps) ran with host syncs as errors; == stepwise")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")

    # one more decode step: grouped GEMM launches per step, then its time unprofiled and profiled
    token = torch.as_tensor(window[:, -1], device="cuda")
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = kernels.launch_counts()["group_gemm"]
    if per_step != 2 * config.num_hidden_layers:
        raise AssertionError(f"group_gemm launched {per_step} times in a decode step, not "
                             f"{2 * config.num_hidden_layers}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    gm(token, session=session)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm(token, session=session)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = max(sum(e.self_device_time_total for e in device) / 1e3, 1e-9)
    n_kernels = sum(e.count for e in device)
    gmm = sum(e.self_device_time_total for e in device if "gmm_" in e.key) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    log("moe full width", f"{card}: one decode step (bs 4, context ~1050): wall {step_ms:.2f} ms unprofiled; "
                          f"device busy {busy:.3f} ms (idle {100 * (1 - busy / step_ms):.1f}%), {n_kernels} "
                          f"kernels; group_gemm {gmm:.3f} ms ({100 * gmm / busy:.1f}% of busy, "
                          f"{per_step} launches)")
    log("moe full width", "device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))

    # the experts of one layer, fed the prefill batch's hidden states, under one routing: all 1650 tokens,
    # and the last token of each request (a decode step's 32 rows)
    layer, plain_layer = model.layers[MOE_LAYER_CHECKED].mlp, plain.layers[MOE_LAYER_CHECKED].mlp
    last = torch.as_tensor(np.cumsum(lens) - 1, device="cuda")
    for name, x in (("prefill batch", mlp_in[0]), ("last tokens", mlp_in[0][last])):
        idx, gates = layer.gating(x)
        sorted_h, per_expert, _, _ = layer.dispatch(x, gates, idx)
        got, want = layer.experts(sorted_h, per_expert), plain_layer.experts(sorted_h, per_expert)
        check_tol_diff(got, want, **tols_for(torch.bfloat16))
        err = (got.float() - want.float()).abs().max().item()
        log("moe full width", f"layer {MOE_LAYER_CHECKED} experts, {name} ({sorted_h.shape[0]} rows over "
                              f"{int((per_expert > 0).sum())} experts), same routing: max_abs_err {err:.4g} vs "
                              f"plain (bf16 ladder {tols_for(torch.bfloat16)})")

    plain_routes, route_hooks = _routes([layer.mlp for layer in plain.layers])
    plain_logits, _ = PagedAttentionGenerationModel(plain, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
    for h in route_hooks:
        h.remove()
    agree = [(a[:, :, None] == b[:, None, :]).any(-1).float().mean().item() for a, b in zip(routes, plain_routes)]
    cos = torch.nn.functional.cosine_similarity(logits, plain_logits, dim=-1)
    log("moe full width", f"top-8 routes the kernel and plain paths agree on: {100 * np.mean(agree):.2f}% over "
                          f"{len(agree)} layers (layer 0 {100 * agree[0]:.2f}%, last {100 * agree[-1]:.2f}%)")
    log("moe full width", f"last-token logits {tuple(logits.shape)} finite; per-row cosine vs plain path "
                          f"{[round(c, 6) for c in cos.tolist()]} (bound {MOE_COSINE_BOUND})")
    if cos.min().item() < MOE_COSINE_BOUND:
        raise AssertionError(f"MoE prefill logits disagree with the plain path: cosine {cos.tolist()}")

    rec = hook.records[-1]
    log("moe full width", f"{card}: prefill {rec['prefill_ms']:.2f} ms ({rec['in_tok']} tokens, bs 4); "
                          f"decode {rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise, "
                          f"{rec['decode_steps']} steps); FusedDecode {fused_ms:.3f} ms/step, "
                          f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak memory "
                          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log("moe full width", f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    _prefill_profile(torch, "moe full width", card, gm, ids, lens)
    del plain, gm, gen, session, mlp_in, routes, plain_routes
    gc.collect()
    torch.cuda.empty_cache()
    return counts, _moe_quant_halves(torch, card, model, ids, lens, logits)


def _moe_quant_halves(torch, card, model, ids, lens, reference) -> dict:
    """Phase 8's w8a8 and w4a8 halves: ``model`` (the bf16 Qwen3-30B-A3B,
    its plain twin gone) turns into both quantized twins one layer at a
    time, each bf16 layer freed once both twins hold it (the embedding,
    the norms and the gate are shared), so the peak stays near the bf16
    model's; then each twin runs ``_serve_and_check`` against its plain
    twin on its tensors (FusedDecode under ``no_host_sync``, the decode
    step's R share, logits against the bf16 model's ``reference``), and one
    layer's experts equal the plain experts under one routing, bit for bit,
    for the prefill batch and the last tokens. Returns each twin's counts."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3MoeForCausalLM, quantize_qwen3_moe_layer, qwen3_moe_twin
    from mojo_opset_tpu_torch.modeling.qwen3.quantize import check_filled
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    modes = {"w8a8": ("int8", MOE_INT8_PATH_KERNELS, MOE_INT8_COSINE_BOUND),
             "w4a8": ("int4", MOE_INT4_PATH_KERNELS, MOE_INT4_COSINE_BOUND)}
    twins = {mode: qwen3_moe_twin(model, weight_dtype) for mode, (weight_dtype, _, _) in modes.items()}
    for i in range(len(model.layers)):
        for mode, twin in twins.items():
            quantize_qwen3_moe_layer(twin.layers[i], model.layers[i], modes[mode][0])
        model.layers[i] = torch.nn.Identity()  # the bf16 layer leaves the card
    del model
    gc.collect()
    torch.cuda.synchronize()
    log("moe quant", f"both twins converted layer by layer in {time.perf_counter() - t0:.1f} s: "
                     + ", ".join(f"{mode} {_weight_gib(twin):.1f} GiB of weights" for mode, twin in twins.items())
                     + f" (the bf16 embedding shared); peak memory during the conversion "
                       f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    counts = {}
    for mode, twin in twins.items():
        check_filled(twin, f"the {mode} conversion")
        tag = f"moe {mode}"
        plain = _plain_twin(torch, twin, Qwen3MoeForCausalLM)
        experts = twin.layers[MOE_LAYER_CHECKED].mlp.experts
        assert type(experts).__name__ == "CudaQuantExperts", type(experts)
        assert type(plain.layers[MOE_LAYER_CHECKED].mlp.experts).__name__ == "RefQuantExperts"
        torch.cuda.reset_peak_memory_stats()
        counts[f"moe_{mode}"], _, _ = _serve_and_check(
            torch, tag, twin, plain, ids, lens, modes[mode][1], card, reference=reference,
            cosine_bound=modes[mode][2], host_sync_errors=True, step_families=("R", "F", "G"))
        # the experts of one layer, fed the prefill batch's hidden states, under one routing
        layer, plain_layer = twin.layers[MOE_LAYER_CHECKED].mlp, plain.layers[MOE_LAYER_CHECKED].mlp
        mlp_in = []
        in_hook = layer.register_forward_pre_hook(lambda mod, args: mlp_in.append(args[0]))
        PagedAttentionGenerationModel(twin, block_size=BLOCK_SIZE)(ids, context_input_len=lens)
        in_hook.remove()
        last = torch.as_tensor(np.cumsum(lens) - 1, device="cuda")
        for name, x in (("prefill batch", mlp_in[0]), ("last tokens", mlp_in[0][last])):
            idx, gates = layer.gating(x)
            sorted_h, per_expert, _, _ = layer.dispatch(x, gates, idx)
            got, want = layer.experts(sorted_h, per_expert), plain_layer.experts(sorted_h, per_expert)
            if not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                raise AssertionError(f"{tag}: layer {MOE_LAYER_CHECKED}'s experts differ from the plain experts "
                                     f"({name}): max_abs_err {err:.4g}")
            log(tag, f"layer {MOE_LAYER_CHECKED} experts, {name} ({sorted_h.shape[0]} rows over "
                     f"{int((per_expert > 0).sum())} experts), same routing: equal to the plain experts bit for bit")
        del plain, mlp_in
        twins[mode] = None
        del twin
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def _deepseek_plain_twin(torch, model):
    """The plain twin of a DeepSeek-V3 model (bf16 or w8a8) on its tensors:
    built on the meta device in the golden tier, except its two paged MLA
    ops, which run kernel I's plain (absorbed) version (the golden paged
    prefill gathers T * K * H * 192 elements, 88 GB here)."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import mla_decode
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaPagedDecodeMLA, CudaPagedPrefillMLA
    from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3ForCausalLM

    with plain_tier():
        plain = DeepseekV3ForCausalLM(model._config, device="meta")
    for layer in plain.model.layers:
        attn = layer.self_attn
        for name, cls in (("attn_decode", CudaPagedDecodeMLA), ("attn_prefill", CudaPagedPrefillMLA)):
            golden = getattr(attn, name)
            op = cls(golden.num_heads, golden.qk_nope_head_dim, golden.qk_rope_head_dim, golden.v_head_dim,
                     golden.kv_lora_rank, device="meta")
            op.attend = mla_decode.mla_decode_absorbed_plain
            setattr(attn, name, op)
    _bind(plain, model)
    attn, plain_attn = model.model.layers[0].self_attn, plain.model.layers[0].self_attn
    assert type(attn.attn_decode).__name__ == "CudaPagedDecodeMLA"
    assert attn.attn_decode.attend is mla_decode.mla_decode_absorbed
    assert plain_attn.attn_decode.attend is mla_decode.mla_decode_absorbed_plain
    assert plain_attn.attn_prefill.kv_b_proj.data_ptr() == attn.attn_decode.kv_b_proj.data_ptr()
    assert type(plain_attn.kv_a_layernorm).__name__ == "RefRMSNorm" and type(plain_attn.rope).__name__ == "RefApplyRoPE"
    moe, plain_moe = model.model.layers[-1].mlp.routed_experts, plain.model.layers[-1].mlp.routed_experts
    experts = "QuantExperts" if model._config.quant else "Experts"
    assert type(moe.experts).__name__ == "Cuda" + experts and type(plain_moe.experts).__name__ == "Ref" + experts
    return plain


def _deepseek_pair(torch, config):
    """The kernel-path DeepSeek-V3 (random weights from seed 0) and its plain twin on the same tensors."""
    from mojo_opset_tpu_torch.modeling.deepseekv3 import DeepseekV3ForCausalLM

    model = DeepseekV3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    return model, _deepseek_plain_twin(torch, model)


def _deepseek_run(torch, card, tag, model, plain, path_kernels, experts_kernel, cosine_bound, reference=None):
    """Phase 9's run for one DeepSeek-V3 model and its plain twin: prefill, DECODE_STEPS greedy steps and a
    FusedDecode window with host syncs as errors, counters zeroed just before and read just after (every kernel of
    ``path_kernels`` must launch, the GQA attention kernels never); one decode step counted (mla_decode once a
    layer, ``experts_kernel`` twice a MoE layer), its MLA decode at DEEPSEEK_LAYER_CHECKED held to the golden op
    on its cache, then timed and profiled; the top-8 route agreement and the last-token logits against the plain
    twin (per-row cosine >= ``cosine_bound``; against ``reference`` printed with no bound); one profiled prefill.
    Peak memory counts from the caller's last reset. Returns (counts, the last-token prefill logits)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.experimental.operators import MojoPagedDecodeMLA
    from mojo_opset_tpu_torch.modeling.deepseekv3 import MLARuntimeState
    from mojo_opset_tpu_torch.runtime import (
        FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook,
    )
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff

    config = model._config
    n_moe = config.num_hidden_layers - config.first_k_dense_replace
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE, session_cls=MLARuntimeState)
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1, hooks=[hook])

    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up
    kernels.reset_launch_counts()
    out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    moe_layers = [layer.mlp.routed_experts for layer in model.model.layers[config.first_k_dense_replace:]]
    routes, route_hooks = _routes(moe_layers)
    logits, session = gm(ids, context_input_len=lens)
    for h in route_hooks:
        h.remove()
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_fused = time.perf_counter()
    with no_host_sync(torch, model):
        window = FusedDecode(model)(session, first, FUSED_STEPS)
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t_fused) * 1e3 / FUSED_STEPS
    counts = kernels.launch_counts()
    log(tag, f"launches on the main path: {counts}")
    if min(counts[k] for k in path_kernels) <= 0:
        raise AssertionError(f"a kernel of the {tag} path never launched: {counts}")
    if counts["paged_decode"] or counts["paged_prefill"]:
        raise AssertionError(f"the GQA attention kernels launched on the MLA path: {counts}")
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    window = window.T.cpu().numpy()
    if not np.array_equal(window, out[:, 1:FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {window.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    log(tag, f"FusedDecode window ({FUSED_STEPS} steps) ran with host syncs as errors; == stepwise")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")

    # one more decode step: launches per step, and one layer's MLA decode held to the golden op on its cache
    token = torch.as_tensor(window[:, -1], device="cuda")
    op = model.model.layers[DEEPSEEK_LAYER_CHECKED].self_attn.attn_decode
    seen = []
    seen_hook = op.register_forward_pre_hook(lambda mod, args: seen.append(args))
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = kernels.launch_counts()
    seen_hook.remove()
    if per_step["mla_decode"] != config.num_hidden_layers or per_step[experts_kernel] != 2 * n_moe:
        raise AssertionError(f"a decode step launched {per_step}: mla_decode must launch "
                             f"{config.num_hidden_layers} times, {experts_kernel} {2 * n_moe}")
    golden = MojoPagedDecodeMLA.get_backend_impl("ref")(op.num_heads, op.qk_nope_head_dim, op.qk_rope_head_dim,
                                                         op.v_head_dim, op.kv_lora_rank, device="meta")
    golden.kv_b_proj = op.kv_b_proj
    with torch.inference_mode():
        got, want = op(*seen[0]), golden(*seen[0])
    check_tol_diff(got, want, **DEEPSEEK_LAYER_TOL)
    err = (got.float() - want.float()).abs().max().item()
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    log(tag, f"layer {DEEPSEEK_LAYER_CHECKED} MLA decode (bs 4, contexts {seen[0][3].tolist()}): kernel I path vs "
             f"the golden decompressing op on the same cache: max_abs_err {err:.4g} (tol {DEEPSEEK_LAYER_TOL}), "
             f"relative norm error {rel:.3g}; output scale {want.float().abs().max().item():.3g}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    gm(token, session=session)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm(token, session=session)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = max(sum(e.self_device_time_total for e in device) / 1e3, 1e-9)
    n_kernels = sum(e.count for e in device)
    mla = sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES["I"])) / 1e3
    fam = "R" if experts_kernel == "group_quant_gemm" else "H"
    moe = sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES[fam])) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    log(tag, f"{card}: one decode step (bs 4, context ~1050): wall {step_ms:.2f} ms unprofiled; device busy "
             f"{busy:.3f} ms (idle {100 * (1 - busy / step_ms):.1f}%), {n_kernels} kernels; mla_decode {mla:.3f} ms "
             f"({100 * mla / busy:.1f}% of busy, {per_step['mla_decode']} launches); {experts_kernel} {moe:.3f} ms "
             f"({100 * moe / busy:.1f}%, {per_step[experts_kernel]} launches)")
    log(tag, "device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))

    plain_moe = [layer.mlp.routed_experts for layer in plain.model.layers[config.first_k_dense_replace:]]
    plain_routes, route_hooks = _routes(plain_moe)
    plain_logits, _ = PagedAttentionGenerationModel(plain, block_size=BLOCK_SIZE, session_cls=MLARuntimeState)(
        ids, context_input_len=lens)
    for h in route_hooks:
        h.remove()
    agree = [(a[:, :, None] == b[:, None, :]).any(-1).float().mean().item() for a, b in zip(routes, plain_routes)]
    cos = torch.nn.functional.cosine_similarity(logits, plain_logits, dim=-1)
    note = ""
    if reference is not None:
        ref_cos = torch.nn.functional.cosine_similarity(logits, reference, dim=-1)
        note = f"; vs the bf16 model {[round(c, 4) for c in ref_cos.tolist()]} (no bound: random weights)"
    log(tag, f"top-8 routes the kernel and plain paths agree on: {[round(100 * a, 3) for a in agree]}% (the {n_moe} "
             f"MoE layers)")
    log(tag, f"last-token logits {tuple(logits.shape)} finite; per-row cosine vs plain path "
             f"{[round(c, 6) for c in cos.tolist()]} (bound {cosine_bound}){note}")
    if cos.min().item() < cosine_bound:
        raise AssertionError(f"{tag}: prefill logits disagree with the plain path: cosine {cos.tolist()}")

    rec = hook.records[-1]
    log(tag, f"{card}: prefill {rec['prefill_ms']:.2f} ms ({rec['in_tok']} tokens, bs 4); decode "
             f"{rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise, {rec['decode_steps']} "
             f"steps); FusedDecode {fused_ms:.3f} ms/step, {len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak "
             f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(tag, f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    _prefill_profile(torch, tag, card, gm, ids, lens)
    return {k: counts[k] for k in path_kernels}, logits


def _weight_gib(model) -> float:
    """GiB of the model's parameters and buffers, each tensor counted once."""
    seen = {}
    for t in [*model.parameters(), *model.buffers()]:
        seen[t.data_ptr()] = t.numel() * t.element_size()
    return sum(seen.values()) / 2**30


def phase_deepseek_full_width(torch, card: str) -> tuple:
    """DeepSeek-V3 at full width, depth cut to its 3 dense and 2 MoE layers,
    bf16, random weights: the MLA path end to end, one layer's MLA decode
    held to the golden op, the logits to the plain twin, one decode step's
    device time; then its w8a8 twin, converted layer by layer on the card
    (each bf16 layer freed once converted), through the same run on kernel
    R. Returns (the bf16 path's counts, {"deepseek_w8a8": its counts})."""
    from mojo_opset_tpu_torch.modeling.deepseekv3 import (
        DeepseekV3Config, deepseek_v3_twin, quantize_deepseek_v3_layer,
    )
    from mojo_opset_tpu_torch.modeling.qwen3.quantize import check_filled

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = DeepseekV3Config(**DEEPSEEK_V3, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, plain = _deepseek_pair(torch, config)
    n_params = sum(p.numel() for p in model.parameters())
    n_moe = config.num_hidden_layers - config.first_k_dense_replace
    log("deepseek full width", f"DeepSeek-V3 widths, depth cut {DEEPSEEK_FULL['num_hidden_layers']} -> "
                               f"{config.num_hidden_layers} ({config.first_k_dense_replace} dense + {n_moe} MoE "
                               f"layers), max_position_embeddings {DEEPSEEK_FULL['max_position_embeddings']} -> "
                               f"{config.max_position_embeddings}: {n_params / 1e9:.2f} B params bf16 "
                               f"({n_params * 2 / 2**30:.1f} GiB), built in {time.perf_counter() - t0:.1f} s; the "
                               f"plain twin shares its tensors")
    counts, logits = _deepseek_run(torch, card, "deepseek full width", model, plain, DEEPSEEK_PATH_KERNELS,
                                   "group_gemm", DEEPSEEK_COSINE_BOUND)

    # the w8a8 half: the plain twin goes, the model turns into its w8a8 twin one layer at a time
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    twin = deepseek_v3_twin(model)
    for i in range(config.num_hidden_layers):
        quantize_deepseek_v3_layer(twin.model.layers[i], model.model.layers[i])
        model.model.layers[i] = torch.nn.Identity()  # the bf16 layer leaves the card (the twin shares its norms)
    check_filled(twin, "the w8a8 conversion")
    del model
    gc.collect()
    torch.cuda.synchronize()
    tag = "deepseek w8a8"
    log(tag, f"converted layer by layer in {time.perf_counter() - t0:.1f} s: {_weight_gib(twin):.1f} GiB of "
             f"weights (the embedding and the fp32 kv_b_proj shared with the bf16 model); peak memory during the "
             f"conversion {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    torch.cuda.reset_peak_memory_stats()
    plain = _deepseek_plain_twin(torch, twin)
    int8_counts, _ = _deepseek_run(torch, card, tag, twin, plain, DEEPSEEK_INT8_PATH_KERNELS, "group_quant_gemm",
                                   DEEPSEEK_INT8_COSINE_BOUND, reference=logits)
    del twin, plain
    gc.collect()
    torch.cuda.empty_cache()
    return counts, {"deepseek_w8a8": int8_counts}


def phase_seed_oss_full_width(torch, card: str) -> tuple:
    """Seed-OSS at Seed-OSS-36B widths, depth cut to 32: the bf16 model on A-D
    and its w8a8 twin, quantized on the card, on A-F, each through phase 5's
    batch against a plain twin on the same tensors."""
    from mojo_opset_tpu_torch.modeling.seed_oss import SeedOssConfig, SeedOssForCausalLM, quantize_seed_oss

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    config = SeedOssConfig(**SEED_OSS_36B, dtype=torch.bfloat16, kv_layout="NHD")
    t0 = time.perf_counter()
    model, plain = _build_pair(torch, config, SeedOssForCausalLM)
    n_params = sum(p.numel() for p in model.parameters())
    log("seed-oss", f"Seed-OSS-36B widths, depth cut {SEED_OSS_FULL['num_hidden_layers']} -> "
                    f"{config.num_hidden_layers}, max_position_embeddings {SEED_OSS_FULL['max_position_embeddings']} "
                    f"-> {config.max_position_embeddings}: {n_params / 1e9:.2f} B params bf16 "
                    f"({n_params * 2 / 2**30:.1f} GiB), built in {time.perf_counter() - t0:.1f} s; the plain twin "
                    f"shares its tensors")
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    bf16_counts, bf16_logits, _ = _serve_and_check(torch, "seed-oss bf16", model, plain, ids, lens,
                                                   BF16_PATH_KERNELS, card)
    del plain
    t0 = time.perf_counter()
    qmodel = quantize_seed_oss(model)
    with plain_tier():
        qplain = SeedOssForCausalLM(qmodel.seed_oss_config, device="meta")
    _bind(qplain, qmodel)
    attn, plain_attn = qmodel.layers[0].self_attn, qplain.layers[0].self_attn
    assert type(qmodel.layers[0].input_layernorm).__name__ == "CudaRMSNormQuant"
    assert type(attn.q_proj).__name__ == "CudaQuantGemm" and type(plain_attn.q_proj).__name__ == "RefQuantGemm"
    assert attn.q_bias is not None and attn.o_bias is None and attn.q_bias.data_ptr() == plain_attn.q_bias.data_ptr()
    both_gib = torch.cuda.max_memory_allocated() / 2**30
    del model  # its projections go; the embedding, norms and biases stay, shared with the twins
    gc.collect()
    torch.cuda.empty_cache()
    n_int8 = sum(p.numel() for p in qmodel.parameters() if p.dtype == torch.int8)
    log("seed-oss w8a8", f"quantized on the card in {time.perf_counter() - t0:.1f} s: {n_int8 / 1e9:.3f} B int8 "
                         f"weights, the q/k/v biases in bf16 beside them; peak with the bf16 model beside it "
                         f"{both_gib:.1f} GiB; {torch.cuda.memory_allocated() / 2**30:.2f} GiB held after it goes")
    torch.cuda.reset_peak_memory_stats()
    int8_counts, _, _ = _serve_and_check(torch, "seed-oss w8a8", qmodel, qplain, ids, lens, INT8_PATH_KERNELS, card,
                                         reference=bf16_logits)
    del qmodel, qplain
    gc.collect()
    torch.cuda.empty_cache()
    return bf16_counts, int8_counts


def _train_step(torch, model, ids, loss_fn, opt=None) -> tuple:
    """One training step on ``ids`` (B, S + 1): ``train_forward`` of the
    first S, ``loss_fn`` (a fused linear + CE op) against the last S,
    backward and, with ``opt``, its update. Returns (loss, forward ms,
    backward ms, update ms), each part ended by a synchronize."""
    inputs, targets = ids[:, :-1], ids[:, 1:].reshape(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hidden = model.train_forward(inputs)
    loss = loss_fn(hidden.reshape(-1, hidden.shape[-1]), model.lm_head_weight, targets)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if opt is not None:
        opt.step()
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    return loss.detach().float(), (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def _loss_ops():
    """The dispatched loss op (kernel N on the card) and the chunked golden."""
    from mojo_opset_tpu_torch.backends.cuda.functions import CudaFusedLinearCrossEntropyFunction
    from mojo_opset_tpu_torch.core.functions import MojoFusedLinearCrossEntropyFunction

    loss_fn = MojoFusedLinearCrossEntropyFunction()
    assert isinstance(loss_fn, CudaFusedLinearCrossEntropyFunction), type(loss_fn)
    return loss_fn, MojoFusedLinearCrossEntropyFunction.get_backend_impl("ref")(chunk_size=TRAIN_LOSS_CHUNK)


def _loss_alone(torch, model, ids, loss_fn) -> tuple:
    """The loss's forward and backward alone on the step's hidden states
    (computed once without autograd): device ms from CUDA events (mean of 3)
    and the memory it takes above what was allocated before it (GiB)."""
    inputs, targets = ids[:, :-1], ids[:, 1:].reshape(-1)
    with torch.no_grad():
        hidden = model.train_forward(inputs).reshape(-1, model.qwen3_config.hidden_size)
    hidden.requires_grad_(True)

    def run():
        loss_fn(hidden, model.lm_head_weight, targets).backward()
        hidden.grad = None

    run()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    ms = cuda_ms(torch, run, iters=3, warmup=1)
    model.zero_grad(set_to_none=True)
    return ms, peak


def _train_model(torch, layers: int):
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM

    config = Qwen3Config(**dict(QWEN3_4B, num_hidden_layers=layers), dtype=torch.bfloat16)
    model = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    model.requires_grad_(True)
    layer = model.model.layers[0]
    attn = layer.self_attn
    for fn, name in ((attn.attn_train, "CudaSWAFunction"), (attn.norm_train, "CudaRMSNormFunction"),
                     (layer.norm_train, "CudaRMSNormFunction"), (model.model.norm_train, "CudaRMSNormFunction"),
                     (attn.rope_train, "CudaApplyRoPEFunction"), (layer.mlp.act_train, "CudaSiluFunction")):
        assert type(fn).__name__ == name, type(fn)
    ids = torch.randint(1, config.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    return model, ids


def _train_launches(layers: int) -> dict:
    """Launches of one training step at ``layers``: A forward and K backward at
    each of a layer's four norms and the final norm, L forward and backward at
    each MLP, M forward and backward (q and k in one launch) and J's three
    entry points at each attention; N's four entry points once at the loss
    (its dz fits DZ_BUDGET_BYTES: one run)."""
    return {"norms": 4 * layers + 1, "rmsnorm_vjp": 4 * layers + 1, "silu_fwd": layers, "silu_bwd": layers,
            "rope_head_first": 2 * layers, "flash_swa_fwd": layers, "flash_swa_dq": layers, "flash_swa_dkv": layers,
            "flce_stats": 1, "flce_dz": 1, "flce_dx": 1, "flce_dw": 1}


def _plain_training_kernels(model, loss_fn) -> None:
    """Set every kernel of ``model``'s training path (A, J, K, L and M) and
    of ``loss_fn`` (N) to its plain version, through the Functions' and J's
    op's seams."""
    from mojo_opset_tpu_torch.backends.cuda.functions import (
        CudaApplyRoPEFunction, CudaRMSNormFunction, CudaSiluFunction,
    )
    from mojo_opset_tpu_torch.backends.cuda.kernels import flash_swa as fs
    from mojo_opset_tpu_torch.backends.cuda.kernels import flce, norms, rmsnorm_vjp, rope_head_first, silu_vjp
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaSWA

    loss_fn.fwd, loss_fn.bwd = flce.flce_stats_plain, flce.flce_backward_plain
    for m in model.modules():
        if isinstance(m, CudaRMSNormFunction):
            m.fwd, m.bwd = norms.rmsnorm_plain, rmsnorm_vjp.rmsnorm_bwd_plain
        elif isinstance(m, CudaSiluFunction):
            m.fwd, m.bwd = silu_vjp.silu_fwd_plain, silu_vjp.silu_bwd_plain
        elif isinstance(m, CudaApplyRoPEFunction):
            m.rotate = rope_head_first.rope_head_first_plain
        elif isinstance(m, CudaSWA):
            m.fwd, m.bwd = fs.flash_swa_fwd_plain, fs.flash_swa_bwd_plain


def _golden_training_functions(model) -> None:
    """Give every module of ``model`` golden-tier training Functions in place of
    the norm, RoPE and SiLU ones (J's stays): the training path without
    kernels A, K, L and M, for comparison within one run."""
    from mojo_opset_tpu_torch.core.functions import MojoApplyRoPEFunction, MojoRMSNormFunction, MojoSiluFunction

    for m in list(model.modules()):
        if hasattr(m, "norm_train"):
            m.norm_train = MojoRMSNormFunction.get_backend_impl("ref")(eps=m.norm_train.eps)
        if hasattr(m, "rope_train"):
            m.rope_train = MojoApplyRoPEFunction.get_backend_impl("ref")()
        if hasattr(m, "act_train"):
            m.act_train = MojoSiluFunction.get_backend_impl("ref")()


def _train_twin_check(torch) -> None:
    """One step at full width, depth cut to TRAIN_TWIN_LAYERS, on the training
    path's kernels (A, J, K, L, M and the loss's N) and again with each one's
    plain version in its place (the same model, so every other tensor and op
    is shared):
    the loss to TRAIN_LOSS_REL_BOUND, each parameter's gradient, the norm
    weights' included, to TRAIN_GRAD_COSINE_BOUND."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.functions import CudaRMSNormFunction
    from mojo_opset_tpu_torch.backends.cuda.kernels import norms

    model, ids = _train_model(torch, TRAIN_TWIN_LAYERS)
    loss_fn, _ = _loss_ops()
    kernels.reset_launch_counts()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss, fwd_ms, bwd_ms, _ = _train_step(torch, model, ids, loss_fn)
    act_gib = (torch.cuda.max_memory_allocated() - mem0) / 2**30
    counts = kernels.launch_counts()
    grads = {name: p.grad for name, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    want = _train_launches(TRAIN_TWIN_LAYERS)
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the twin check's kernel step launched {counts}, want {want}")
    _plain_training_kernels(model, loss_fn)
    plain_loss, *_ = _train_step(torch, model, ids, loss_fn)
    if kernels.launch_counts() != counts:
        raise AssertionError(f"the plain twin launched a kernel: {kernels.launch_counts()} after {counts}")
    loss_gap = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    cos = {name: torch.nn.functional.cosine_similarity(grads[name].float().flatten(), p.grad.float().flatten(),
                                                       dim=0).item()
           for name, p in model.named_parameters()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    # the loss reads the forward kernels only (A, J, L, M and N's statistics; L and M match their plain versions bit
    # for bit in phase 3): a step whose one kernel is A's forward shows A's share of the gap
    model.zero_grad(set_to_none=True)
    for m in model.modules():
        if isinstance(m, CudaRMSNormFunction):
            m.fwd = norms.rmsnorm
    a_loss, *_ = _train_step(torch, model, ids, loss_fn)
    a_gap = abs(a_loss.item() - plain_loss.item()) / abs(plain_loss.item())
    log("train full width", f"twin check ({TRAIN_TWIN_LAYERS} layers at Qwen3-4B width, B {TRAIN_BATCH} x S "
                            f"{TRAIN_SEQ}): loss {loss.item():.9g} on A, J, K, L, M and N, {plain_loss.item():.9g} on "
                            f"their plain versions (relative gap {loss_gap:.3g}, bound {TRAIN_LOSS_REL_BOUND}; "
                            f"{a_gap:.3g} with A alone on its kernel); gradient cosine over {len(cos)} parameters: "
                            f"lowest {[(n, round(c, 6)) for n, c in worst]} (bound {TRAIN_GRAD_COSINE_BOUND}); "
                            f"kernel step forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms; step memory above "
                            f"the weights {act_gib:.2f} GiB")
    if not loss_gap <= TRAIN_LOSS_REL_BOUND:
        raise AssertionError(f"the loss disagrees with the plain twin: relative gap {loss_gap}")
    if worst[0][1] < TRAIN_GRAD_COSINE_BOUND:
        raise AssertionError(f"gradients disagree with the plain twin: {worst}")
    del model, grads
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_full_width(torch, card: str) -> dict:
    """Qwen3 training at Qwen3-4B geometry: the twin check, then AdamW steps
    at depth TRAIN_LAYERS on one repeated batch, counted and profiled, the
    same steps with the chunked golden loss in place of kernel N, then with
    the golden norms, RoPE and SiLU, for comparison."""
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.functions import CudaFusedLinearCrossEntropyFunction
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa

    gc.collect()
    torch.cuda.empty_cache()
    _train_twin_check(torch)
    t0 = time.perf_counter()
    model, ids = _train_model(torch, TRAIN_LAYERS)
    config = model.qwen3_config
    n_params = sum(p.numel() for p in model.parameters())
    n_dense = n_params - model.model.embed_tokens.weight.numel()  # the lookup does no product
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR, fused=True)
    log("train full width", f"Qwen3-4B geometry, depth {TRAIN_LAYERS} of {QWEN3_4B['num_hidden_layers']}, "
                            f"{n_params / 1e9:.3f} B params bf16, AdamW (fused, lr {TRAIN_LR}), built in "
                            f"{time.perf_counter() - t0:.1f} s")
    loss_fn, golden_loss = _loss_ops()
    sdpa_golden, loss_golden = CudaSdpa.golden_calls, CudaFusedLinearCrossEntropyFunction.golden_calls
    torch.cuda.reset_peak_memory_stats()
    losses = [_train_step(torch, model, ids, loss_fn, opt)[0].item()]  # warm-up: AdamW states, allocator
    kernels.reset_launch_counts()
    steps = [_train_step(torch, model, ids, loss_fn, opt) for _ in range(TRAIN_STEPS)]
    counts = kernels.launch_counts()
    losses += [s[0].item() for s in steps]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: TRAIN_STEPS * v for k, v in _train_launches(TRAIN_LAYERS).items()}
    log("train full width", f"launches over {TRAIN_STEPS} steps: {counts}")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"the training path's kernels launched {counts}, want {want}")
    if CudaSdpa.golden_calls != sdpa_golden:
        raise AssertionError("the training path took CudaSdpa's golden route")
    if CudaFusedLinearCrossEntropyFunction.golden_calls != loss_golden:
        raise AssertionError("the training path's loss took the golden route")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"the loss must be finite and fall: {losses}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _train_step(torch, model, ids, loss_fn, opt)
        prof_ms = (time.perf_counter() - t) * 1e3
    busy, fam_ms, top = _step_profile(torch, prof)
    loss_ms, loss_gib = _loss_alone(torch, model, ids, loss_fn)

    fwd, bwd, upd = (float(np.mean([s[i] for s in steps])) for i in (1, 2, 3))
    step_ms = fwd + bwd + upd
    tokens = TRAIN_BATCH * TRAIN_SEQ
    pairs = TRAIN_BATCH * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2  # causal (query, key) pairs a head
    attn_flops = 3 * 4 * config.head_dim * config.num_attention_heads * pairs * TRAIN_LAYERS  # forward + 2x backward
    flops = 6 * n_dense * tokens + attn_flops
    log("train full width", f"losses {[round(x, 4) for x in losses]} (warm-up step first)")
    log("train full width", f"{card}: step {step_ms:.1f} ms (forward + loss {fwd:.1f}, backward {bwd:.1f}, "
                            f"AdamW {upd:.1f}; mean of {TRAIN_STEPS}), {tokens * 1e3 / step_ms:.0f} tokens/s, "
                            f"mfu {100 * flops / (step_ms * 1e-3) / PEAK_OPS['bf16']:.2f}% ((6 x {n_dense / 1e9:.3f} "
                            f"B params x {tokens} tokens + {attn_flops / 1e12:.2f} T attention) / step / 989 "
                            f"TFLOP/s); peak memory {peak_gib:.1f} GiB")
    log("train full width", f"profiled step: wall {prof_ms:.1f} ms, device busy {busy:.1f} ms (idle "
                            f"{100 * (1 - busy / prof_ms):.1f}%); " + ", ".join(
                                f"kernel {f} {ms:.2f} ms ({100 * ms / busy:.1f}% of busy)" for f, ms in fam_ms.items()))
    log("train full width", "device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}" for e in top))

    # the same model and steps with the chunked golden loss (A, J, K, L and M kept): what kernel N replaced
    torch.cuda.reset_peak_memory_stats()
    _train_step(torch, model, ids, golden_loss, opt)
    kernels.reset_launch_counts()
    g_steps = [_train_step(torch, model, ids, golden_loss, opt) for _ in range(2)]
    if any(kernels.launch_counts()[k] for k in ("flce_stats", "flce_dz", "flce_dx", "flce_dw")):
        raise AssertionError(f"the golden loss launched kernel N: {kernels.launch_counts()}")
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _train_step(torch, model, ids, golden_loss, opt)
    g_busy, _, _ = _step_profile(torch, prof)
    g_loss_ms, g_loss_gib = _loss_alone(torch, model, ids, golden_loss)
    g_ms = [float(np.mean([s[i] for s in g_steps])) for i in (1, 2, 3)]
    log("train full width", f"{card}: loss tiers in one run. Kernel N: step {step_ms:.1f} ms, device busy "
                            f"{busy:.1f} ms, N {fam_ms['N']:.2f} ms of it, the loss alone (forward + backward, CUDA "
                            f"events) {loss_ms:.2f} ms and {loss_gib:.2f} GiB above the step's hidden states, step "
                            f"peak {peak_gib:.2f} GiB. Chunked golden loss ({TRAIN_LOSS_CHUNK} rows a chunk): step "
                            f"{sum(g_ms):.1f} ms (forward + loss {g_ms[0]:.1f}, backward {g_ms[1]:.1f}, AdamW "
                            f"{g_ms[2]:.1f}; mean of 2), device busy {g_busy:.1f} ms, the loss alone {g_loss_ms:.2f} "
                            f"ms and {g_loss_gib:.2f} GiB, step peak {g_peak:.2f} GiB")
    if peak_gib > g_peak:
        raise AssertionError(f"the step's peak memory with kernel N ({peak_gib:.2f} GiB) is above the golden "
                             f"loss's ({g_peak:.2f} GiB)")

    # the same model with golden norms, RoPE and SiLU (J stays): what K, L and M replaced, in this run
    _golden_training_functions(model)
    torch.cuda.reset_peak_memory_stats()
    _train_step(torch, model, ids, loss_fn, opt)
    kernels.reset_launch_counts()
    golden = [_train_step(torch, model, ids, loss_fn, opt) for _ in range(2)]
    golden_counts = kernels.launch_counts()
    if any(golden_counts[k] for k in ("norms", "rmsnorm_vjp", "silu_fwd", "silu_bwd", "rope_head_first")):
        raise AssertionError(f"the golden Functions launched a kernel: {golden_counts}")
    golden_peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _train_step(torch, model, ids, loss_fn, opt)
    golden_busy, golden_fam, _ = _step_profile(torch, prof)
    g_fwd, g_bwd, g_upd = (float(np.mean([s[i] for s in golden])) for i in (1, 2, 3))
    replaced = golden_busy - busy + sum(fam_ms[f] for f in "AKLM")
    log("train full width", f"{card}: the same step with golden norms, RoPE and SiLU under autograd (J kept): "
                            f"{g_fwd + g_bwd + g_upd:.1f} ms (forward + loss {g_fwd:.1f}, backward {g_bwd:.1f}, AdamW "
                            f"{g_upd:.1f}; mean of 2), device busy {golden_busy:.1f} ms, J {golden_fam['J']:.2f} ms, "
                            f"peak memory {golden_peak:.1f} GiB; the golden norm, RoPE and SiLU work took "
                            f"~{replaced:.1f} ms of device time ({100 * replaced / golden_busy:.1f}% of its busy "
                            f"time), A, K, L and M take {sum(fam_ms[f] for f in 'AKLM'):.2f} ms")
    del model, opt, prof
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def _cosine(torch, a, b) -> float:
    return torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(), dim=0).item()


def _wan_pair(torch, cfg):
    """The kernel-path WanModel (random weights from seed 0) and a plain-path twin (MOJO_BACKEND=ref: the golden
    SDPA and RMSNorm) bound to the same tensors and RoPE table."""
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanModel

    model = WanModel(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    with plain_tier():
        plain = WanModel(cfg, device="meta")
    _bind(plain, model)
    plain.freqs = model.freqs
    attn, plain_attn = model.blocks[0].self_attn, plain.blocks[0].self_attn
    assert type(attn.sdpa).__name__ == "CudaSdpa" and type(attn.norm_q).__name__ == "CudaRMSNorm"
    assert type(plain_attn.sdpa).__name__ == "RefSdpa" and type(plain_attn.norm_q).__name__ == "RefRMSNorm"
    return model, plain


def _wan_inputs(torch, cfg, latents, text_rows, seed):
    """Random latents of the given shapes and ``text_rows`` random text-embedding rows for each."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = [torch.randn(shape, device="cuda", generator=gen) for shape in latents]
    ctx = [torch.randn(text_rows, cfg.text_dim, device="cuda", generator=gen) for _ in latents]
    return xs, ctx


def _dit_profile(torch, fn) -> tuple:
    """Device busy ms of ``fn`` under torch.profiler and the device ms of kernels J, O and A."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    families = {"J": ("flash_swa",), "O": ("flash_diffusion",), "A": A_KERNEL_NAMES}
    fam_ms = {f: sum(e.self_device_time_total for e in device if any(p in e.key for p in pats)) / 1e3
              for f, pats in families.items()}
    return busy, fam_ms


def _wan_small_check(torch) -> None:
    """A small fp32 DiT (WAN_SMALL) against its plain twin, a clip alone and a ragged clip + image batch, within the
    fp32 rung of utils/acc.py; J, A and (ragged) O must launch."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    cfg = WanConfig(**WAN_SMALL)
    model, plain = _wan_pair(torch, cfg)
    xs, ctx = _wan_inputs(torch, cfg, [(16, 2, 8, 12), (16, 1, 8, 12)], 20, seed=3)
    t = torch.tensor([700.0, 300.0], device="cuda")
    for label, n in (("clip", 1), ("ragged clip + image", 2)):
        kernels.reset_launch_counts()
        with torch.inference_mode():
            got = model(xs[:n], t[:n], ctx[:n], seq_len=48)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            want = plain(xs[:n], t[:n], ctx[:n], seq_len=48)
        for g, w in zip(got, want):
            check_tol_diff(g, w, **tols_for(torch.float32))
        expect = {"norms": 8, "flash_swa_fwd": 4 if n == 1 else 2, **({"flash_diffusion_fwd": 2} if n == 2 else {})}
        if counts != expect:
            raise AssertionError(f"the small DiT ({label}) launched {counts}, want {expect}")
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        log("wan dit", f"small fp32 DiT ({WAN_SMALL['num_layers']} layers, dim {WAN_SMALL['dim']}), {label}: "
                       f"max_abs_err {err:.3g} against the plain twin (tol {tols_for(torch.float32)}); launches "
                       f"{counts}")
    del model, plain


def phase_wan_dit(torch, card: str) -> dict:
    """Phase 12: the Wan2.2-TI2V-5B DiT at full width and depth in bf16: (a) WAN_UNIFORM_STEPS Euler steps of one
    17-frame clip (self- and cross-attention on J), (b) WAN_RAGGED_STEPS steps of the clip beside a one-frame image
    padded to its 4400 tokens (self-attention on O under the key-padding mask, cross-attention on J); velocities
    and final latents against the plain twin, (b)'s clip against (a)'s. Returns (b)'s launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
    from mojo_opset_tpu_torch.benchmark.dit_protocol import PerfDiTRunner, dit_step_flops
    from mojo_opset_tpu_torch.modeling.wan2_2 import WanConfig

    gc.collect()
    torch.cuda.empty_cache()
    _wan_small_check(torch)
    t0 = time.perf_counter()
    cfg = WanConfig(**WAN_TI2V_5B, dtype=torch.bfloat16)
    model, plain = _wan_pair(torch, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    seq_len = WAN_CLIP[1] * (WAN_CLIP[2] // 2) * (WAN_CLIP[3] // 2)
    full_len = (WAN_FULL_FRAMES - 1) // 4 + 1
    log("wan dit", f"Wan2.2-TI2V-5B: {n_params / 1e9:.3f} B params bf16 ({torch.cuda.memory_allocated() / 2**30:.1f} "
                   f"GiB), built in {time.perf_counter() - t0:.1f} s; clip latent {WAN_CLIP} = {seq_len} tokens (frames "
                   f"cut {WAN_FULL_FRAMES} -> 17: {full_len * (WAN_CLIP[2] // 2) * (WAN_CLIP[3] // 2)} -> {seq_len} "
                   f"tokens), context {WAN_TEXT_ROWS} rows padded to {cfg.text_len}")
    (clip, image), ctx = _wan_inputs(torch, cfg, [WAN_CLIP, WAN_IMAGE], WAN_TEXT_ROWS, seed=1)
    golden0 = CudaSdpa.golden_calls
    L = cfg.num_layers
    runs = {}
    for tag, xs, steps, want in (
            ("(a) uniform clip", [clip], WAN_UNIFORM_STEPS, {"norms": 4 * L, "flash_swa_fwd": 2 * L}),
            ("(b) ragged clip + image", [clip, image], WAN_RAGGED_STEPS,
             {"norms": 4 * L, "flash_swa_fwd": L, "flash_diffusion_fwd": L})):
        c = ctx[:len(xs)]
        t = torch.full((len(xs),), 999.0, device="cuda")
        with torch.inference_mode():
            model(xs, t, c, seq_len=seq_len)  # warm-up: cuBLAS handles, allocator
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            first, final, ms = PerfDiTRunner(model).denoise(xs, c, seq_len, steps)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy, fam = _dit_profile(torch, lambda: model(xs, t, c, seq_len=seq_len))
            plain_first, plain_final, plain_ms = PerfDiTRunner(plain).denoise(xs, c, seq_len, steps)
        expect = {k: v * steps for k, v in want.items()}
        if counts != expect:
            raise AssertionError(f"wan dit {tag}: launches {counts}, want {expect}")
        cos_v = [_cosine(torch, a, b) for a, b in zip(first, plain_first)]
        cos_x = [_cosine(torch, a, b) for a, b in zip(final, plain_final)]
        if not all(torch.isfinite(v).all() for v in (*first, *final)):
            raise AssertionError(f"wan dit {tag}: non-finite velocities or latents")
        # useful work counts each request's own tokens; the padded figure counts every row the batch computes
        tokens = [math.prod(n // p for n, p in zip(x.shape[1:], cfg.patch_size)) for x in xs]
        tflops = sum(dit_step_flops(cfg, n, cfg.text_len) for n in tokens) / (ms * 1e-3) / 1e12
        tflops_padded = dit_step_flops(cfg, seq_len, cfg.text_len) * len(xs) / (ms * 1e-3) / 1e12
        log("wan dit", f"{card}: {tag}, {steps} steps: {ms:.2f} ms/step (CUDA events; plain twin {plain_ms:.2f}), "
                       f"{tflops:.2f} TFLOP/s, mfu {100 * tflops / 989:.2f}% (dit_step_flops of each request's own "
                       f"tokens {tokens} at {cfg.text_len} context keys; counting the {len(xs)} x {seq_len} padded rows: "
                       f"{tflops_padded:.2f} TFLOP/s, mfu {100 * tflops_padded / 989:.2f}%); one profiled step: device "
                       f"busy {busy:.2f} ms (idle "
                       f"{100 * (1 - busy / ms):.1f}% of the unprofiled step), J {fam['J']:.2f} ms, O {fam['O']:.2f} "
                       f"ms, A {fam['A']:.2f} ms; peak memory {peak:.2f} GiB; launches {counts}")
        log("wan dit", f"{tag}: velocity cosine vs the plain twin at the first step {[round(c, 6) for c in cos_v]}, "
                       f"final latents {[round(c, 6) for c in cos_x]} (bound {WAN_COSINE_BOUND})")
        if min(cos_v + cos_x) < WAN_COSINE_BOUND:
            raise AssertionError(f"wan dit {tag} disagrees with the plain twin: {cos_v}, {cos_x}")
        runs[tag] = (first, counts)
    cos_ab = _cosine(torch, runs["(b) ragged clip + image"][0][0], runs["(a) uniform clip"][0][0])
    log("wan dit", f"(b)'s clip velocity against (a)'s at the first step: cosine {cos_ab:.6f} (bound "
                   f"{WAN_COSINE_BOUND}); CudaSdpa golden calls {CudaSdpa.golden_calls - golden0}")
    if cos_ab < WAN_COSINE_BOUND:
        raise AssertionError(f"the ragged batch's clip parts from the uniform run: cosine {cos_ab}")
    if CudaSdpa.golden_calls != golden0:
        raise AssertionError("a CudaSdpa call took the golden on the DiT's path")
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()
    return runs["(b) ragged clip + image"][1]


def phase_diffusion_function(torch, card: str) -> dict:
    """Phase 13: MojoDiffusionAttentionFunction forward and backward, the cuda tier (kernel O) against the ref tier's
    autograd of the golden, at the Function's shape and at SDAR-30B-A3B's GQA; o, dq, dk, dv relative to their size
    (DIFFUSION_GOLDEN_REL_LIMITS); fwd + bwd ms and peak memory of each tier. Returns the cuda tier's launches of one
    timed fwd + bwd."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.experimental.functions import MojoDiffusionAttentionFunction, block_diffusion_mask

    gen = torch.Generator(device="cuda").manual_seed(5)
    counts = None
    for label, hq, hkv, S in (("Function shape", DIFFUSION_H, DIFFUSION_H, DIFFUSION_S),
                              ("SDAR-30B-A3B GQA", SDAR_HQ, SDAR_HKV, SDAR_S)):
        B, D = DIFFUSION_B, DIFFUSION_D
        q, do = ((torch.randn(B, hq, S, D, device="cuda", generator=gen) * 0.2).to(torch.bfloat16) for _ in range(2))
        k, v = ((torch.randn(B, hkv, S, D, device="cuda", generator=gen) * 0.2).to(torch.bfloat16) for _ in range(2))
        mask = block_diffusion_mask(S, DIFFUSION_BLOCK, device="cuda")
        out, ms, peak = {}, {}, {}
        for tier in ("cuda", "ref"):
            fn = MojoDiffusionAttentionFunction.get_backend_impl(tier)()
            assert type(fn).__name__ == {"cuda": "CudaDiffusionAttentionFunction",
                                         "ref": "RefDiffusionAttentionFunction"}[tier]
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

            def step():
                y = fn(*leaves, mask, 1.0 / D**0.5, hq != hkv)
                return (y.detach(), *torch.autograd.grad(y, leaves, do))

            out[tier] = step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            ms[tier] = cuda_ms(torch, step, iters=5, warmup=1)
            if tier == "cuda":
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
                if counts != {"flash_diffusion_fwd": 6, "flash_diffusion_dq": 6, "flash_diffusion_dkv": 6}:
                    raise AssertionError(f"the cuda tier's fwd + bwd launched {counts}, want O's three entry points "
                                         f"once a call")
            peak[tier] = (torch.cuda.max_memory_allocated() - base) / 2**30
        notes = []
        for name, got, want in zip(("o", "dq", "dk", "dv"), out["cuda"], out["ref"]):
            whole, row, rms = rel_errors(got, want)
            notes.append(f"{name} {whole:.3g} / {row:.3g} (rms {rms:.3g})")
            if not (whole <= DIFFUSION_GOLDEN_REL_LIMITS[0] and row <= DIFFUSION_GOLDEN_REL_LIMITS[1]):
                raise AssertionError(f"diffusion function {label}: {name} relative error {whole:.3g} (worst row "
                                     f"{row:.3g}) over {DIFFUSION_GOLDEN_REL_LIMITS}")
        log("diffusion function", f"{card}: {label} (B {B}, {hq}/{hkv} heads, S {S}, D {D}, block {DIFFUSION_BLOCK}, "
                                  f"bf16): cuda tier vs ref autograd, relative whole / worst row: {'; '.join(notes)} "
                                  f"(limits {DIFFUSION_GOLDEN_REL_LIMITS}); fwd + bwd {ms['cuda']:.2f} ms on O, "
                                  f"{ms['ref']:.2f} ms on the golden; peak above the inputs {peak['cuda']:.2f} GiB, "
                                  f"{peak['ref']:.2f} GiB")
        del out, q, k, v, do
        torch.cuda.empty_cache()
    return counts


def _rel_checker(torch, limits: dict, *dtypes):
    """A ``compare`` check: each output of the dtype's type and shape, to its dtype's ladder, then relative to its
    size to ``limits`` (by operand kind: whole tensor, worst row)."""
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    def check(got, want):
        got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
        notes = []
        for g, w, dt in zip(got, want, dtypes):
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"output {g.dtype} {tuple(g.shape)} against {w.dtype} {tuple(w.shape)}")
            check_tol_diff(g, w, **tols_for(dt))
            whole, row, rms = rel_errors(g, w)
            limit = limits[_kind(torch, dt)]
            if not (whole <= limit[0] and row <= limit[1]):
                raise AssertionError(f"relative error {whole:.3g} (worst row {row:.3g}) over limit {limit} for an "
                                     f"output of RMS {rms:.3g}")
            notes.append(f"{tols_for(dt)}, relative {whole:.3g}, worst row {row:.3g} (limit {limit}), rms {rms:.3g}")
        return " / ".join(notes)
    return check


def _residual_add_cases(torch, compare, gen) -> None:
    """P: residual add + RMSNorm, pre and post, against its plain version on the same inputs: at Qwen3-4B's prefill
    rows and the JAX perf shapes in bf16 (main: timed from a CUDA graph beside its bound and F.rms_norm after the
    add, two calls), then fp16 and fp32, an fp32 residual beside bf16 rows, odd T and D, T = 1 and a misaligned
    view. Outputs to the dtype ladder and to SLICE_E_REL_LIMITS, their dtypes to the golden's."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import norms

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    t0 = time.perf_counter()
    cases = [(shape, bf16, bf16, pos, True, 0) for shape in RESIDUAL_ADD_SHAPES for pos in ("pre", "post")]
    cases += [((4096, 4096), f16, f16, "pre", False, 0), ((4096, 4096), f32, f32, "post", False, 0),
              ((4096, 4096), bf16, f32, "pre", False, 0), ((4096, 4096), bf16, f32, "post", False, 0),
              ((1000, 1000), bf16, bf16, "pre", False, 0), ((1000, 1000), f16, f32, "post", False, 0),
              ((1, 2560), bf16, bf16, "post", False, 0), ((1, 100), f32, f32, "pre", False, 0),
              ((37, 512), bf16, bf16, "pre", False, 1), ((64, 128), bf16, f32, "post", False, 3),
              ((300, 7168), bf16, bf16, "post", False, 0), ((5, 33), f16, f16, "pre", False, 0)]
    for (T, D), dtype, rdtype, pos, main, offset in cases:
        h = torch.randn(T * D + offset, device="cuda", generator=gen).to(dtype)[offset:].view(T, D)
        r = torch.randn(T, D, device="cuda", generator=gen).to(rdtype)
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        w_lib = w.to(dtype)
        res_dtype = torch.result_type(h, r) if pos == "pre" else dtype
        n, isz = T * D, h.element_size()
        bound = (n * (2 * isz + r.element_size() + torch.finfo(res_dtype).bits // 8) + 4 * D, 6 * n, "fp32")
        compare("residual_add_rmsnorm", lambda: norms.residual_add_rmsnorm(h, r, w, 1e-6, pos),
                lambda: norms.residual_add_rmsnorm_plain(h, r, w, 1e-6, pos), dtype,
                f"residual_add_rmsnorm ({T}, {D}) {pos} residual {str(rdtype).split('.')[-1]}"
                f"{' misaligned' if offset else ''}", main, key=f"{T}x{D}_{pos}",
                check=_rel_checker(torch, SLICE_E_REL_LIMITS, dtype, res_dtype), bound=bound,
                library=lambda: torch.nn.functional.rms_norm(h + r, (D,), w_lib, 1e-6))
    log("kernel residual_add_rmsnorm", f"P's cases took {time.perf_counter() - t0:.1f} s; library_ms is two calls: "
                                       f"the add, then F.rms_norm")


def _conv1d_cases(torch, compare, gen) -> None:
    """Q: the causal conv1d forward and backward, each against its plain version on the same inputs: at the conv
    Function's benchmark shape (B 8, T 8192, D 2048, W 4, SiLU, bf16 rows, fp32 weight and bias) and the perf
    descriptor's (T 2048) (main: timed from a CUDA graph beside the bound and depthwise F.conv1d with bias, which
    leaves out the SiLU, and its autograd backward, with the kernels' plan, registers and blocks an SM), JAX's test
    matrix, fp16, D not a multiple of 128, W 16 (the generic kernels), a misaligned view, W 2 and 3 on the conv
    Function's rows and T 257 in fp16 from a state. Outputs to the dtype ladder and to SLICE_E_REL_LIMITS; dx, dw
    and db bit for bit over two runs."""
    from mojo_opset_tpu_torch.backends.cuda import build
    from mojo_opset_tpu_torch.backends.cuda.kernels import conv1d_vjp as cv

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    t0 = time.perf_counter()
    # (B, T, D, W, bias, state, act, dtype, main, offset): the two benchmark shapes, JAX's matrix
    # (tests/accuracy/functions/test_conv_silu_vjp_pallas.py:32-48; its residual is added outside the kernel), then
    # the rest
    cases = [(CONV_B, CONV_T, CONV_D, CONV_W, True, True, True, bf16, True, 0),
             (CONV_B, CONV_PERF_T, CONV_D, CONV_W, True, False, True, bf16, True, 0),
             (2, 64, 128, 4, True, False, True, f32, False, 0), (1, 200, 256, 4, True, False, False, f32, False, 0),
             (2, 48, 128, 3, False, True, True, f32, False, 0), (2, 64, 128, 4, True, True, True, bf16, False, 0),
             (1, 5, 128, 4, True, True, False, f32, False, 0), (2, 96, 128, 8, True, True, True, f32, False, 0),
             (2, 64, 128, 1, True, False, True, f32, False, 0),
             (2, 300, 2048, 4, True, True, True, f16, False, 0), (3, 130, 100, 4, True, True, True, bf16, False, 0),
             (2, 777, 72, 16, True, True, True, bf16, False, 0), (2, 1, 2048, 4, True, True, True, bf16, False, 0),
             (2, 129, 256, 2, False, True, False, bf16, False, 1),
             # the exact-width kernels at W 2 and 3 on the conv Function's rows, and a short fp16 run from a state
             (CONV_B, CONV_T, CONV_D, 2, True, True, True, bf16, False, 0),
             (CONV_B, CONV_T, CONV_D, 3, True, True, True, bf16, False, 0),
             (CONV_B, 257, CONV_D, 4, True, True, True, f16, False, 0)]
    for B, T, D, W, bias, state, act, dtype, main, offset in cases:
        n = B * T * D
        x = torch.randn(n + offset, device="cuda", generator=gen).to(dtype)[offset:].view(B, T, D)
        g = torch.randn(B, T, D, device="cuda", generator=gen).to(dtype)
        w = torch.randn(D, W, device="cuda", generator=gen) * 0.3
        b = torch.randn(D, device="cuda", generator=gen) * 0.1 if bias else None
        st = (torch.randn(B, W - 1, D, device="cuda", generator=gen) if state else
              torch.zeros(B, W - 1, D, device="cuda")).to(dtype)
        isz = x.element_size()
        lib_fwd = lib_bwd = None
        if main:  # depthwise F.conv1d over the (B, D, W-1+T) stream laid out beforehand, bias, no SiLU
            stream = torch.cat([st, x], 1).transpose(1, 2).contiguous().requires_grad_(True)
            w_lib = w.to(dtype)[:, None, :].requires_grad_(True)
            b_lib = (b if b is not None else torch.zeros(D, device="cuda")).to(dtype).requires_grad_(True)
            lib_fwd = lambda: torch.nn.functional.conv1d(stream, w_lib, b_lib, groups=D)  # noqa: E731
            out = lib_fwd()
            g_lib = g.transpose(1, 2).contiguous()
            lib_bwd = lambda: torch.autograd.grad(out, (stream, w_lib, b_lib), g_lib, retain_graph=True)  # noqa: E731
        name = (f"B {B} T {T} D {D} W {W} bias={bias} state={state} act={act}{' misaligned' if offset else ''} on "
                f"the {cv.route(W)} kernels")
        key = f"b{B}_t{T}" if main else None
        notes = {}
        if main:
            vec = int(D % (16 // isz) == 0 and not offset)
            for direction in ("fwd", "bwd"):
                chunk, groups, slots = cv.plan(B, T, D, W, 16 // isz if vec else 1, direction == "bwd",
                                               build.sm_count(x.device))
                res = build.resources("mojo_conv1d_resources", W, vec, int(direction == "bwd"), cv.RING, cv.THREADS,
                                      cv.PREFETCH, build.dtype_code(x))
                notes[direction] = (f"chunks of {chunk} rows, {groups} x {slots} blocks, {res['regs']} registers a "
                                    f"thread, {res['blocks_per_sm']} blocks an SM, {res['spill_bytes']} spill bytes")
        compare("conv1d_fwd", lambda: cv.conv1d_fwd(x, w, b, st, act), lambda: cv.conv1d_fwd_plain(x, w, b, st, act),
                dtype, f"conv1d forward {name}", main, key=key, check=_rel_checker(torch, SLICE_E_REL_LIMITS, dtype),
                bound=(2 * n * isz + st.numel() * isz + 4 * D * (W + 1), (2 * W + (4 if act else 0)) * n, "fp32"),
                library=lib_fwd, note=notes.get("fwd"))
        compare("conv1d_bwd", lambda: cv.conv1d_bwd(x, w, b, st, g, act),
                lambda: cv.conv1d_bwd_plain(x, w, b, st, g, act), dtype, f"conv1d backward {name}", main, key=key,
                check=_rel_checker(torch, SLICE_E_REL_LIMITS, dtype, f32, f32),
                bound=(3 * n * isz + st.numel() * isz + 4 * D * (2 * W + 2), (6 * W + 7) * n, "fp32"),
                library=lib_bwd, library_graph=False, note=notes.get("bwd"))
        runs = [cv.conv1d_bwd(x, w, b, st, g, act) for _ in range(2)]
        if not all(torch.equal(p, q) for p, q in zip(*runs)):
            raise AssertionError(f"conv1d_bwd {name}: two runs on the same inputs differ")
        del x, g, st
    log("kernel conv1d", f"every case's dx, dw and db equal bit for bit over two runs; Q's cases took "
                         f"{time.perf_counter() - t0:.1f} s; library_ms is depthwise F.conv1d with bias, no SiLU")
    try:
        cv.conv1d_fwd(torch.zeros(1, 4, 8, device="cuda"), torch.zeros(8, 17, device="cuda"), None,
                      torch.zeros(1, 16, 8, device="cuda"), True)
    except ValueError as e:
        log("kernel conv1d", f"W = 17 refused: {e}")
    else:
        raise AssertionError("conv1d_fwd took W = 17")


def phase_residual_add_norm(torch, card: str) -> dict:
    """Phase 14: MojoResidualAddRMSNorm built through dispatch (CudaResidualAddRMSNorm, kernel P) against the ref
    tier on the same tensors, at RESIDUAL_ADD_SHAPES in bf16, pre and post: P launches once a call and nothing else
    does; both outputs to the bf16 ladder, their cosine and relative error to RESIDUAL_ADD_GOLDEN_REL_LIMITS; ms per
    call on P and on the golden. Returns the counts of the timed calls."""
    from mojo_opset_tpu_torch import MojoResidualAddRMSNorm
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gen = torch.Generator(device="cuda").manual_seed(14)
    total = {}
    for T, D in RESIDUAL_ADD_SHAPES:
        h = torch.randn(T, D, device="cuda", generator=gen).to(torch.bfloat16)
        r = torch.randn(T, D, device="cuda", generator=gen).to(torch.bfloat16)
        w = torch.rand(D, device="cuda", generator=gen) + 0.5
        for pos in ("pre", "post"):
            op = MojoResidualAddRMSNorm(D, 1e-6, pos, device="cuda")
            golden = MojoResidualAddRMSNorm.get_backend_impl("ref")(D, 1e-6, pos, device="cuda")
            if type(op).__name__ != "CudaResidualAddRMSNorm":
                raise AssertionError(f"dispatch gave {type(op).__name__}")
            op.weight.copy_(w)
            golden.weight.copy_(w)
            kernels.reset_launch_counts()
            got = op(h, r)
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            if counts != {"residual_add_rmsnorm": 1}:
                raise AssertionError(f"one call launched {counts}, want P once")
            want = golden(h, r)
            notes = []
            for label, gt, wt in zip(("out", "residual"), got, want):
                check_tol_diff(gt, wt, **tols_for(torch.bfloat16))
                whole, row, _ = rel_errors(gt, wt)
                cosine = _cosine(torch, gt, wt)
                if not (whole <= RESIDUAL_ADD_GOLDEN_REL_LIMITS[0] and row <= RESIDUAL_ADD_GOLDEN_REL_LIMITS[1]):
                    raise AssertionError(f"residual-add norm ({T}, {D}) {pos} {label}: relative {whole:.3g} (worst "
                                         f"row {row:.3g}) over {RESIDUAL_ADD_GOLDEN_REL_LIMITS}")
                notes.append(f"{label} max_abs {(gt.float() - wt.float()).abs().max().item():.3g}, cosine "
                             f"{cosine:.7f}, relative {whole:.3g} / {row:.3g}")
            kernels.reset_launch_counts()
            p_ms = cuda_ms(torch, lambda: op(h, r), iters=20)
            for k, v in kernels.launch_counts().items():
                if v:
                    total[k] = total.get(k, 0) + v
            g_ms = cuda_ms(torch, lambda: golden(h, r), iters=20)
            log("residual add norm", f"{card}: ({T}, {D}) bf16 {pos}: {'; '.join(notes)} (limits "
                                     f"{RESIDUAL_ADD_GOLDEN_REL_LIMITS}); {p_ms:.4f} ms a call on P, {g_ms:.4f} ms on "
                                     f"the golden")
    if set(total) != {"residual_add_rmsnorm"}:
        raise AssertionError(f"the timed calls launched {total}")
    return total


def phase_conv_function(torch, card: str) -> dict:
    """Phase 15: MojoCausalConv1dFunction forward + backward, the cuda tier (kernel Q) against the ref tier's
    autograd of the golden, at the conv Function's benchmark shape, in two forms: an initial state with
    output_final_state, and a residual. out, the final state and every gradient (dx, dw, db, dstate, dresidual)
    relative to their size (CONV_GOLDEN_REL_LIMITS); Q's forward and backward once a call; fwd + bwd ms and
    peak memory of each tier; one varlen call takes the golden and only it counts in golden_calls. Returns the
    cuda tier's launches of the timed calls."""
    from mojo_opset_tpu_torch import MojoCausalConv1dFunction
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.functions import CudaCausalConv1dFunction

    gen = torch.Generator(device="cuda").manual_seed(15)
    B, T, D, W = CONV_B, CONV_T, CONV_D, CONV_W
    x = torch.randn(B, T, D, device="cuda", generator=gen).to(torch.bfloat16)
    do = torch.randn(B, T, D, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(D, W, device="cuda", generator=gen) * 0.3
    b = torch.randn(D, device="cuda", generator=gen) * 0.1
    s0 = torch.randn(B, D, W - 1, device="cuda", generator=gen).to(torch.bfloat16)
    res = torch.randn(B, T, D, device="cuda", generator=gen).to(torch.bfloat16)
    golden_before = CudaCausalConv1dFunction.golden_calls
    total = {}
    for label, with_state, with_residual in (("state + final state", True, False), ("residual", False, True)):
        out, ms, peak = {}, {}, {}
        for tier in ("cuda", "ref"):
            fn = MojoCausalConv1dFunction.get_backend_impl(tier)()
            if type(fn).__name__ != {"cuda": "CudaCausalConv1dFunction", "ref": "RefCausalConv1dFunction"}[tier]:
                raise AssertionError(f"{tier} tier resolved to {type(fn).__name__}")
            leaves = {"x": x, "w": w, "b": b}
            if with_state:
                leaves["state"] = s0
            if with_residual:
                leaves["residual"] = res
            leaves = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}

            def step():
                y, fin = fn(leaves["x"], leaves["w"], leaves["b"], leaves.get("residual"), leaves.get("state"),
                            with_state, "silu")
                grads = torch.autograd.grad(y, list(leaves.values()), do)
                return (y.detach(), *([fin.detach()] if with_state else []), *grads)

            out[tier] = step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launch_counts()
            ms[tier] = cuda_ms(torch, step, iters=5, warmup=1)
            if tier == "cuda":
                counts = {k: v for k, v in kernels.launch_counts().items() if v}
                if counts != {"conv1d_fwd": 6, "conv1d_bwd": 6}:
                    raise AssertionError(f"the cuda tier's fwd + bwd launched {counts}, want Q's two entry points "
                                         f"once a call")
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
            peak[tier] = (torch.cuda.max_memory_allocated() - base) / 2**30
        names = ["out"] + (["final state"] if with_state else []) + ["d" + k for k in leaves]
        notes = []
        for name, got, want in zip(names, out["cuda"], out["ref"]):
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"conv function {label}: {name} {got.dtype} {tuple(got.shape)} against "
                                     f"{want.dtype} {tuple(want.shape)}")
            whole, row, rms = rel_errors(got, want)
            notes.append(f"{name} {whole:.3g} / {row:.3g} (rms {rms:.3g})")
            if not (whole <= CONV_GOLDEN_REL_LIMITS[0] and row <= CONV_GOLDEN_REL_LIMITS[1]):
                raise AssertionError(f"conv function {label}: {name} relative error {whole:.3g} (worst row "
                                     f"{row:.3g}) over {CONV_GOLDEN_REL_LIMITS}")
        log("conv function", f"{card}: {label} (B {B}, T {T}, D {D}, W {W}, SiLU, bf16, fp32 weight and bias): cuda "
                             f"tier vs ref autograd, relative whole / worst row: {'; '.join(notes)} (limits "
                             f"{CONV_GOLDEN_REL_LIMITS}); fwd + bwd {ms['cuda']:.3f} ms on Q, {ms['ref']:.3f} ms "
                             f"on the golden; peak above the inputs {peak['cuda']:.2f} GiB, {peak['ref']:.2f} GiB")
        del out
        torch.cuda.empty_cache()
    if CudaCausalConv1dFunction.golden_calls != golden_before:
        raise AssertionError("the cuda tier took the golden route without cu_seqlens")
    cu = torch.tensor([0, 3000, T], dtype=torch.int32, device="cuda")
    fn = MojoCausalConv1dFunction()
    kernels.reset_launch_counts()
    y, _ = fn(x[:1], w, b, None, None, False, "silu", cu)
    torch.cuda.synchronize()
    if CudaCausalConv1dFunction.golden_calls != golden_before + 1 or any(kernels.launch_counts().values()):
        raise AssertionError("the varlen call did not take the golden route alone")
    whole, _ = MojoCausalConv1dFunction.get_backend_impl("ref")()(x[:1, 3000:], w, b, None, None, False, "silu")
    if not torch.equal(y[:, 3000:], whole):
        raise AssertionError("the varlen call's second sequence differs from the sequence alone")
    log("conv function", "a cu_seqlens call took the golden route (golden_calls + 1, no launch); only it did")
    return total


def _step_profile(torch, prof) -> tuple:
    """Device busy ms of a profiled step, the device ms of kernels J, A, K, L,
    M and N, and the eight largest entries."""
    from torch.autograd import DeviceType

    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = max(sum(e.self_device_time_total for e in device) / 1e3, 1e-9)
    # K's column sum of its dw partial rows is its own launch (Q's, which shares it, runs in no train step)
    families = {"J": ("flash_swa",), "A": A_KERNEL_NAMES, "K": ("rmsnorm_bwd_", "mojo_column_sum_kernel"),
                "L": ("silu_fwd_", "silu_bwd_"), "M": ("rope_strided_kernel",), "N": ("flce_",)}
    fam_ms = {f: sum(e.self_device_time_total for e in device if any(p in e.key for p in pats)) / 1e3
              for f, pats in families.items()}
    return busy, fam_ms, sorted(device, key=lambda e: -e.self_device_time_total)[:8]


def kernels_line(record: dict, counts: dict, bf16_counts: dict, spec_counts: dict, moe_counts: dict,
                 deepseek_counts: dict, train_counts: dict, seed_counts: dict, seed_int8_counts: dict,
                 dit_counts: dict, fn_counts: dict, res_counts: dict, conv_counts: dict, quant_counts: dict) -> list:
    """One entry per kernel: launches from the int8 full-width run (it runs
    the first six), for G from the w4a8 speculative run, for H from the
    MoE run, for I from the DeepSeek run, for J, K, L, M and N from the
    training run, for O's forward from the Wan DiT's ragged run and for its
    dq and dk/dv from the diffusion Function's, for P from the residual-add
    norm's run, for Q from the conv Function's and for R from phase 8's w8a8
    half (``quant_counts``: phase 8's w8a8 and w4a8 and phase 9's w8a8
    counts, by path); numbers of the main-path
    case (``ms`` replayed from a CUDA graph). C and D add their int8-page numbers, C its windowed cases
    at ctx 32768 beside the same cases without windows; A, F, G, H, I, K, M, P
    and Q their numbers at each shape (M: each layout and direction; P: pre
    and post), A, G, H, I, K, M, P and Q their largest error over those shapes;
    J's forward its numbers through CudaSdpa at the Wan DiT's shape and its
    clip's; O its numbers at SDAR's GQA and under the Wan DiT's key-padding
    mask."""
    line = []
    conv_main = f"b{CONV_B}_t{CONV_T}"
    main_shapes = {"norms": f"{sum(PROMPT_LENS)}x2560", "int8_matmul": f"{sum(PROMPT_LENS)}x2560x9728",
                   "int4_matmul": INT4_MAIN_SHAPE,
                   "group_gemm": GMM_MAIN_SHAPE, "group_quant_gemm": GMM_MAIN_SHAPE, "mla_decode": "decode_bs4",
                   "rmsnorm_vjp": f"{TRAIN_TOKENS}x2560",
                   "rope_head_first": "token_first_view_forward",
                   "residual_add_rmsnorm": "x".join(map(str, RESIDUAL_ADD_SHAPES[0])) + "_pre",
                   "conv1d_fwd": conv_main, "conv1d_bwd": conv_main}
    for module, (name, source, replaces) in KERNEL_INFO.items():
        rec = dict(record[module])
        extra = {}
        if module in main_shapes:
            extra["by_shape"] = rec
            rec = dict(rec[main_shapes[module]])
            extra["main_shape"] = main_shapes[module]
            if module in ("norms", "int4_matmul", "group_gemm", "group_quant_gemm", "mla_decode", "rmsnorm_vjp",
                          "rope_head_first", "residual_add_rmsnorm", "conv1d_fwd", "conv1d_bwd"):
                rec["max_abs_err"] = max(r["max_abs_err"] for r in extra["by_shape"].values())
        for key in ("int8_pages", "wan_dit_sdpa", "wan_dit_clip_sdpa", "window_ctx32k", "no_window_ctx32k",
                    "window_ctx32k_int8", "no_window_ctx32k_int8", "sdar_gqa", "wan_dit_key_padding",
                    *(f"bs{bs}_ctx4000" for bs in DECODE_GRID_BS)):
            if key in rec:
                extra[key] = rec.pop(key)
        for path, path_counts in (("bf16", bf16_counts), ("w4a8_speculative", spec_counts), ("moe", moe_counts),
                                  ("deepseek", deepseek_counts), ("train", train_counts), ("seed_oss", seed_counts),
                                  ("seed_oss_int8", seed_int8_counts), ("wan_dit", dit_counts),
                                  ("diffusion_function", fn_counts), ("residual_add_norm", res_counts),
                                  ("conv_function", conv_counts), *quant_counts.items()):
            if module in path_counts:
                extra[f"launches_{path}_path"] = path_counts[module]
        launches = {"int4_matmul": spec_counts, "group_gemm": moe_counts, "mla_decode": deepseek_counts,
                    "group_quant_gemm": quant_counts["moe_w8a8"], "flash_diffusion_fwd": dit_counts,
                    "flash_diffusion_dq": fn_counts, "flash_diffusion_dkv": fn_counts,
                    "residual_add_rmsnorm": res_counts, "conv1d_fwd": conv_counts,
                    "conv1d_bwd": conv_counts}.get(module, counts if module in counts else train_counts)[module]
        line.append(dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                         max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
                         bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                         eager_ms=rec["eager_ms"], **extra))
    return line


def main() -> int:
    import torch

    def timed(name, phase, *args):
        t0 = time.perf_counter()
        result = phase(*args)
        log(name, f"phase took {time.perf_counter() - t0:.1f} s")
        return result

    card = phase_device(torch)
    timed("build", phase_build)
    record = timed("kernels", phase_kernels, torch)
    timed("small models", phase_small_model, torch)
    def model_phase(name, phase, *args):
        """A model phase (5-12): no op of the path may take a golden route."""
        before = golden_counts()
        result = timed(name, phase, *args)
        after = golden_counts()
        if after != before:
            raise AssertionError(f"{name}: golden routes taken: "
                                 f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }")
        return result

    bf16_counts = model_phase("full width", phase_full_width, torch, card)
    counts = model_phase("int8 full width", phase_int8_full_width, torch, card)
    spec_counts, spec_routes = model_phase("w4a8 speculative", phase_w4a8_speculative, torch, card)
    moe_counts, quant_counts = model_phase("moe full width", phase_moe_full_width, torch, card)
    deepseek_counts, deepseek_int8_counts = model_phase("deepseek full width", phase_deepseek_full_width, torch, card)
    quant_counts.update(deepseek_int8_counts)
    train_counts = model_phase("train full width", phase_train_full_width, torch, card)
    seed_counts, seed_int8_counts = model_phase("seed-oss full width", phase_seed_oss_full_width, torch, card)
    dit_counts = model_phase("wan dit", phase_wan_dit, torch, card)
    log("golden routes", f"every golden_calls stayed put over phases 5-12: {golden_counts()}")
    fn_counts = timed("diffusion function", phase_diffusion_function, torch, card)
    res_counts = timed("residual add norm", phase_residual_add_norm, torch, card)
    conv_counts = timed("conv function", phase_conv_function, torch, card)
    line = kernels_line(record, counts, bf16_counts, spec_counts, moe_counts, deepseek_counts, train_counts,
                        seed_counts, seed_int8_counts, dit_counts, fn_counts, res_counts, conv_counts, quant_counts)
    next(k for k in line if k["name"] == KERNEL_INFO["int4_matmul"][0])["launches_by_route"] = spec_routes
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
