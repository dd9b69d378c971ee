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
     and blocks an SM, and its standing case (K_STANDING_SHAPES on the generic
     kernels, unaligned, each seed on a generator of its own; K's fp32 dx on
     the same values within K_FP32_GAP_LIMIT of the plain version's, its bf16
     dx that fp32 dx rounded once, parting from the plain bf16 dx by one ulp
     at most); L (SiLU forward and backward) at (4096, 9728); M (RoPE over a
     strided head-first view, forward and backward) on q (2, 32, 2048, 128)
     and k (2, 8, 2048, 128) head-first, token-first as a transposed view
     and as (T, H, D) rows; each output to its ladder and, relative to its
     size, to TRAIN_KERNEL_REL_LIMITS. Kernel N (fused linear + CE: stats, dz,
     dx, dw) at the train step's lm_head (N 4096, H 2560, V 151936, bf16),
     at the vocab-parallel loss's shards of it (V 75968 at tp 2 with label
     smoothing over the whole vocabulary, V 37984 at tp 4; targets drawn
     over the whole vocabulary and shifted, so most fall outside the
     shard; both timed), then fp16, fp32, every option of JAX's test matrix, ragged N and V,
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
  7. w4a8 speculative decoding at full width (bench.py:298-331), depth cut
     36 -> SPEC_LAYERS: a bf16 Qwen3-4B target from seed 0, its w4a8 twin
     quantized on the card as
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
     heads, q/k/v biases, vocab 155136), depth cut 64 -> 16, bf16, random
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
 16. Wan2.2's text -> DiT -> video path, run right after phase 12: a small
     fp32 umT5 encoder and VAE (T5_SMALL, VAE_SMALL) on the card against the
     CPU port on the same numpy weights (fp32 ladder; the VAE's convolutions
     in TF32 and in full fp32, set by torch.backends.cudnn.flags);
     umT5-xxl (24 layers, dim 4096, 64 heads, vocabulary 256384) at
     full width and depth in bf16, random weights from seed 0, encoding two
     requests of 96 and 23 random tokens padded to 512: each request's rows
     against it encoded alone (per-row cosine >= T5_ROW_COSINE_BOUND), 24
     golden CudaSdpa calls an encode (the additive float bias takes the golden,
     as JAX's Pallas tier does); the 96-token context into phase 12's
     Wan2.2-TI2V-5B DiT (taken over, not built again, freed after) for 2
     Euler steps of the clip latents (48, 5, 44, 80) from seeded noise (A 4L
     and J 2L launches a step, the first velocity against the plain twin >=
     WAN_COSINE_BOUND); the final latents through Wan2.2's VAE (WAN_VAE:
     dim 160, decoder 256, z 48, the published 4x temporal stride; fp32
     inputs and weights, TF32 convolutions as PyTorch's default gives them;
     cuDNN deterministic): a (3, 17, 704, 1280) video, finite, in [-1, 1], its
     first frame the first latent frame decoded alone (bit for bit, else
     cosine >= VAE_CAUSAL_COSINE_BOUND), the decode timed again in full fp32
     (the videos' cosine printed); a seeded 704 x 1280
     image encoded to (48, 1, 44, 80). Prints encode ms and tokens/s, the
     steps' ms, decode and encode ms, video frames/s, the VAE's parameters,
     each stage's peak memory above its start and the phase's seconds; no
     golden route but the T5's.
 17. CUDA graphs (``runtime/compile_cache.py``), JAX's capture suite
     (tests/accuracy/operators/test_attention_capture.py) at its small
     shapes: a store and a decode through one CompiledStepPool graph equal
     to eager bit for bit over 5 steps, on bf16 pages (C), with SWA windows
     (C), on int8 (C8) pages (C') and on MLA latents (I); two sessions of
     batch 2 and 3 stepped in turns through one pool (2 graphs, no
     cross-talk); a permuted block table permuting a replay's rows; a top-k
     FusedDecode window on a small bf16 Qwen3 whose generator the graph
     registers (one seed: the warm-up and two replays alike; unseeded, new
     draws).
 18. The distributed layer (``mojo_opset_tpu_torch.parallel``), after
     phase 17: a one-rank NCCL world through the port's
     ``init_distributed`` (a ``file://`` rendezvous in a temporary
     directory) and its (tp, ep) groups; Qwen3-4B at full width in bf16
     (phase 5's geometry and prompts) through ``qwen3_tp_rules`` at tp 1,
     then Qwen3-30B-A3B at full width cut to TP_MOE_LAYERS layers through
     ``qwen3_tp_rules + moe_ep_rules`` at tp 1 x ep 1, each against its
     unsharded twin from the same seed: prefill logits bit for bit (a
     one-rank collective is an identity), TP_STEPS greedy steps stepwise and
     in a FusedDecode window, on graphs (the NCCL collectives captured) and
     eager, one token stream, the graphed steps' logits bit for bit, every
     kernel of the path launched; a decode step of each on its graph timed
     in turns and profiled (its NCCL kernels). Then Qwen3-4B at full width
     and tp 2 in two processes on the one card: NCCL refuses two ranks on
     one device, so gloo carries the CUDA tensors, eager (a graph asked for
     over gloo must raise); both ranks one stream, which may part from the
     unsharded stream only at a near-tie (TP2_TIE_GAP), prefill logits'
     per-row cosine >= TP2_COSINE_BOUND. The same spawn runs phase 23's tp
     2 checks: greedy speculative decoding of the sharded target with its
     w8a8 draft (``quantize_qwen3`` of the whole model, then sharded; k
     TP2_SPEC_K; graphs asked for over gloo must raise, so eager), and the
     w8a8 + C8 twin (``quantize_qwen3(quant_kv=True)``, then sharded): both
     streams under the near-tie rule against the unsharded model's and
     twin's, each rank's C8 channel scales against the unsharded twin's
     rows of its kv heads (C8_TP2_SCALE_REL_BOUND). No golden route.
 19. The runtime tooling through the port's example entry points, under
     MOJO_NATIVE=1 (the native block allocator built from
     ``runtime/native/block_allocator.cpp`` into ``_build/``; a failed
     build fails the phase): ``llm_inference --greedy --max-new-tokens
     TOOLING_STEPS`` at its default width (JAX's ``Qwen3Config()``: hidden
     4096, 32 layers, vocab 151936, bf16), each run a session on the native
     allocator: (a) on graphs, counted (A-D must launch; these counts join
     the kernels line as ``launches_tooling_path``); (b) eager under
     ``--debug-compare TOOLING_COMPARE --debug-dump TOOLING_DUMP``: the
     compare records by op equal to ``_expected_compare_records`` a forward,
     each cos_sim >= TOOLING_COSINE_BOUND, no swallowed error, one dump a
     forward, the worst max_abs by op printed; (c) on graphs with the
     debugger enabled through its API: one capture warning, the tokens of
     (a), records only from the prefill and the graph's eager warm-up step;
     (d) ``--profile-dir`` and ``--trace-out``: kernels A-D named in the
     profiler's chrome trace, with one ``mojo.graph.replay`` a graphed
     decode step beside them, and the runtime's spans in the emitter's
     (one ``mojo.generate``, one ``mojo.prefill``, one
     ``mojo.decode_step`` a decode step). Then
     ``llm_inference --tiny`` with ``--quant w8a8 --quant-kv`` and with
     ``--speculative 4``, ``continuous_serving`` and ``dit_inference`` at
     their defaults (shapes, finiteness). Then two readings, not claims:
     the host us of a decode step's reserve and metadata, native against
     numpy, at ALLOC_BATCHES, ctx ALLOC_CTX, in turns; the bf16 Qwen3-4B
     graph step on a session of each allocator at the same batches, each
     step synchronized, in turns. No golden route.
 20. The rest of the ops (``phase_rest_ops``), bf16 unless named, seed 0:
     JAX's MojoQwen3MoeBlock at its defaults (REST_MOE_BLOCK: vocab 10000,
     hidden 4096, 32 heads x 128, 8 experts, top-2; B 2 x S 1024) on its
     cuda tier (A, J and H must launch, no golden route) against its ref
     tier on the same tensors (tokens whose top-2 both tiers pick, at least
     REST_ROUTE_SHARE of them, within the bf16 ladder); at Qwen3-4B's
     attention geometry (32/8 heads x 128, block 64, PROMPT_LENS) the
     masked paged decode (True = exclude) and prefill (True = keep), each
     with a 2-D and a 3-D mask (golden routes, counted), MojoPagedPrefillSWA
     and MojoPagedPrefillSWAWithKVDequant (int8 pages) with REST_WINDOWS,
     MojoPagedDecodeNstepSWA at S REST_NSTEP, each against the same op in
     fp32 on the CPU (REST_REL_LIMITS), windowless MojoPagedPrefillSWA
     against kernel D and the one-step NstepSWA against kernel C; MojoIndexer
     at JAX's defaults (REST_INDEXER) in fp32, a 2048-token causal prefill
     and 4 single-token steps, its scores against the CPU's
     (REST_INDEXER_LIMITS), its top-k against the CPU's (``_topk_agree``),
     CudaApplyRoPE's golden route once a call; NSA at the NSA paper's
     settings (REST_NSA) in fp32, paged decode at bs 4 over ctx 8192 and a
     paged prefill of 128 tokens on a 2048-key sequence (REST_NSA_LIMITS);
     Sage prefill at Qwen3-4B's geometry; MojoOverEncoding at Qwen3-4B's
     vocabulary and width, dense and NF4, B 4 x T 512 and a varlen call,
     its n-gram ids exactly; the rotate activation at 7168, the attention
     gate, the group and in-place norms, MRoPE in place (one bf16 rounding
     of the fp32 CPU run), StoreLowrank and the reduce-sum GEMM (exactly).
     Each op logs its max error, its limit and its ms (CUDA events).
 21. HF checkpoints on disk (``phase_hf_checkpoint``), a model phase: a
     bf16 Qwen3 at Qwen3-4B's published config.json (HF_QWEN3_4B: tied,
     rope_theta 1e6), weights drawn on the card from seed 0, written by
     this script's own minimal safetensors writer as two shards with
     ``model.safetensors.index.json`` and ``config.json`` in a temporary
     directory beside this script (free disk checked first), loaded by
     ``apply_mojo_to_qwen3(dir, device="cuda", strict=True)``: every state
     tensor bit-equal to the source model's; HF_PROMPTS (mixed lengths,
     the byte-level fallback tokenizer) through ``MojoGenerator.__call__``,
     greedy, HF_STEPS tokens, stepwise and fused, on the source and the
     loaded model: tokens and every step's logits bit-identical; the
     loaded model's stepwise serve counted (A-D must launch), then again
     with the typewriter on (the same launches and tokens). A child
     process under MOJO_DETERMINISTIC=1 loads the checkpoint and serves
     it twice stepwise and once fused, greedy, then twice stepwise and
     twice fused with top-HF_TOP_K sampling from seed 0
     (``_deterministic_serve``): each pair bit-identical, tokens and
     logits. Then Qwen3-30B-A3B's
     config.json cut to HF_MOE_LAYERS layers (reduced depth), the experts
     under HF's per-expert names and the router as ``mlp.gate.weight`` in
     bf16, through ``apply_mojo_to_qwen3_moe(strict=True)``, the same
     checks, H among the kernels that must launch. Logs the bytes, write
     and load seconds and GB/s; the directory is removed at the end.
 22. the perf harness and protocols (``phase_harness``): (a) ``run_perf``'s
     smoke preset in process over all 52 descriptors
     (``benchmark/specs``), tiers ref and cuda, on the card, chains from
     HARNESS_ITERS calls: any case that raises fails the phase, every
     time above 0, each spec that names kernels (C's, D's) timed by the
     profiler on its cuda records or the reason printed, each cuda
     record's route printed and a golden one failing the phase; then each cuda-tier op's
     output held to its golden's on the same inputs and weights (each
     dtype's ladder; int8 within one step on at most HARNESS_INT8_STEPS;
     kernel M's Function on RoPE tables, HARNESS_ROPE_TABLES); (b)
     ``PerfMojoGenerator`` at Qwen3-4B's geometry (random bf16 weights
     from seed 0, block 64): prefill at HARNESS_PREFILL, decode at
     HARNESS_DECODE_BS at ctx 4000, HARNESS_NEW_TOKENS new tokens, fused
     windows; every rate above 0, no golden route, A-D launched; then
     one HARNESS_PREFILL[0]-token prefill's model call timed with and
     without a sync and one recorded prefill traced by the profiler hook
     (device busy ms, the host's costliest runtime calls and ops); (c)
     ``run_dit_perf`` at the JAX package's defaults (dim 2048, 32 layers,
     bf16, ``PerfDiTRunner.SIZES``, 4 steps); (d) ``launch``: the mesh
     sweep on a one-rank NCCL group at 4096 (a child process), the
     per-device fan-out on the one card with ``--ops RMSNorm``. The
     in-process launches of (a)-(c) go into the kernels line by path.
Decode runs on CUDA graphs by default (phases 4-9 and 11): a key's first
call is its eager warm-up, its second captures. Phase 4 runs every graphed
generator twice and checks it against device_graph=False; phases 5, 6, 8,
9 and 11 check 32 graphed steps and two FusedDecode windows (the second
replayed, then replayed again from the same state and timed) against
device_graph=False token for token, a replayed step's launch counts
against its eager warm-up's, its logits against an eager step's (bit for
bit, else per-row cosine >= GRAPH_COSINE_BOUND), and time GRAPH_TURNS graph
and eager steps in turns (``_graph_vs_eager``: device busy and idle share
of a graph step, capture ms, the graph pool's memory); phase 7 does the
same for vanilla and speculative decoding (``_speculative_turns``).
Phases 5-12, 18, 19, 21 and 23 (the models, the quantized halves of 8 and 9
among them) must leave every cuda-tier class's golden_calls where it was: a
golden route on a model path fails its phase.
 23. dp x tp training and the rest of the distributed layer
     (``phase_train_parallel``), a model phase: (a) one-rank NCCL groups
     (dp 1 x tp 1, the port's ``init_distributed``): Qwen3-4B's widths cut
     to TRAIN_TP_LAYERS layers, B TRAIN_BATCH x S TRAIN_SEQ, the sharded
     train step (``train_forward`` under the styles, the vocab-parallel
     loss on kernel N, backward, ``finish_gradients``, fused AdamW at
     optax.adamw(1e-4)'s settings) against the unsharded step on the same
     weights and batch, in turns: the loss and every gradient of the first
     turn and every parameter after the last, bit for bit or the gap
     printed (the loss within TRAIN_LOSS_REL_BOUND, each gradient's cosine
     >= TRAIN_GRAD_COSINE_BOUND), the sharded step's launches exactly
     ``_train_launches``, step ms in turns and a profiled step's NCCL
     kernels; greedy speculative decoding of SMALL sharded with its w8a8
     draft, draft rounds and verifies replayed from graphs (the NCCL
     collectives captured), == the unsharded greedy stream; the ring
     AllGatherGemm and GemmReduceScatter (cuda tier) on the group of one,
     the plain GEMM bit for bit (as in JAX), timed. (b) dp 2 x tp 2 in four
     processes on the one card over gloo: Qwen3-4B's widths cut to
     TRAIN_DP_LAYERS layers, B TRAIN_BATCH x S TRAIN_DP_SEQ a dp rank,
     against the unsharded step on the whole batch in each process: the
     dp-mean loss within TRAIN_DP_LOSS_REL_BOUND, every parameter's
     gradient against its shard of the unsharded gradient at a cosine of
     at least TRAIN_DP_COSINE_BOUND; J, K, L, M, N and A launched on every
     rank, no golden route; the ring ops refuse CUDA tensors over gloo.
     The ring's arithmetic across ranks is checked on the CPU only (NCCL
     refuses two ranks on one card). Its launches join the kernels line
     by path.
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
# its depth: Qwen3-4B's 36 layers cut to 18, for the smoke's clock once phase 23 came (PERF.md section 4)
SPEC_LAYERS = 18
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
# limit leaves 6-8x. Both versions round one fp32 value once, and where a rounding boundary falls between their two
# fp32 values they part by one ulp: on a small tensor one such element reads more than the whole-tensor limit (one
# bf16 ulp at one element of (37, 128) reads 1.1e-4 to 4.5e-4), so each whole-tensor reading of K (and K's alone:
# its standing case is the evidence) is held to the larger of its limit and TRAIN_KERNEL_ROUNDING_ULPS ulps of the
# output's largest element over its norm. That floor lies
# above the 1e-4 only below ~6 x 10^5 elements ((37, 128) bf16: ~9e-4; the step's (4096, 2560): ~3e-5); K's standing
# case (K_STANDING_SHAPES) showed K's fp32 dx within 1.4e-6 of the plain version's RMS and every bf16 part one such
# rounding (PERF.md, section 6)
TRAIN_KERNEL_REL_LIMITS = {"bf16": (1e-4, 1e-2), "fp16": (5e-5, 5e-4), "fp32": (3e-6, 3e-6)}
TRAIN_KERNEL_ROUNDING_ULPS = 2
# kernel K's standing case (ROADMAP.md queue 3): the (37, 128) bf16 view 2 bytes off alignment read a dx relative
# error of 1.1e-4 on one draw of phase 3's shared generator. These small shapes on K's generic kernels (every view
# one element off alignment) run every seed on a generator of its own, so no other case moves their draws; each is
# also run in fp32 on the same values, which gives the fp32 dx that K rounds to bf16 (the same generic kernel)
K_STANDING_SHAPES = ((37, 128), (9, 96), (5, 33), (13, 2560))
K_STANDING_SEEDS = tuple(range(256))
# K's fp32 dx against the plain version's fp32 dx (before either rounds to bf16), as the largest gap over the
# tensor's RMS: both sum in fp32 in other orders, so they part by a few fp32 ulps (~1e-7 of the RMS); 1e-5 is
# still ~200x under half a bf16 ulp, so a bf16 element where they part by more than a rounding shows as a fault
K_FP32_GAP_LIMIT = 1e-5
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
# o or MLP bias, an untied lm_head. The depth is cut 64 -> 16 (about 10.2 B params, 19 GiB in bf16; 32 layers until
# phase 23 came, halved for the smoke's clock) and the positions 524288 -> 1088 (the KV pool: the longest prompt, its
# decode steps and one more)
SEED_OSS_36B = dict(
    hidden_size=5120, intermediate_size=27648, num_attention_heads=80, num_key_value_heads=8, num_hidden_layers=16,
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
# phase 16: Wan2.2's text -> DiT -> video path. umT5-xxl (google/umt5-xxl, config.json: d_model 4096, d_ff 10240,
# 64 heads of 64, 24 layers, 32 relative buckets in every layer, vocabulary 256384) at full width and depth in
# bf16, Wan2.2's T5 dtype (the Wan2.2 repo's wan/configs/shared_config.py); two requests of 96 and 23 valid tokens
# padded to the DiT's text_len 512 (random ids: the repo has no tokenizer)
T5_REQUEST_LENS = (96, 23)
T5_ROW_COSINE_BOUND = 0.999
WAN_T2V_STEPS = 2
# Wan2.2's VAE (the Wan2.2 repo's wan/configs/wan_ti2v_5B.py: z_dim 48, vae_stride (4, 16, 16)) as JAX's
# Wan2_2_VAE builds it, with the temporal downsampling of the published 4x stride passed by name: JAX's default
# (True, True, True) strides time 8x (ROADMAP.md, JAX-side notes). 5 latent frames decode to 17 video frames
WAN_VAE = dict(dim=160, dec_dim=256, z_dim=48, temperal_downsample=(False, True, True))
WAN_VIDEO = (3, 17, 704, 1280)
# the first decoded frame against the first latent frame decoded alone, where cuDNN's sums for the two calls'
# shapes differ: the cosine of the two frames
VAE_CAUSAL_COSINE_BOUND = 0.99999
# the small fp32 twin check of phase 16: a 2-layer umT5 (dim 64, 4 heads of 16) and a VAE with the published
# stage layout at dim 16, z 8, on 5 frames of 64 x 64
T5_SMALL = dict(vocab=512, dim=64, dim_attn=64, dim_ffn=128, num_heads=4, num_layers=2, num_buckets=32,
                shared_pos=False)
VAE_SMALL = dict(dim=16, dec_dim=16, z_dim=8, temperal_downsample=(False, True, True))
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
    128, int8 and int4; DeepSeek-V3's, G 256, int8; decode at bs 4, 32 rows from one top-8 routing, on the decode
    tile, and the prefill batch's 13200 rows, on the wgmma route), then groups of 0, 1, 15, 16, 17 and 129 rows, an
    empty tail, N and K off the tiles, both routes and every output dtype. Every case equals the plain version bit for bit and repeats bit for bit; each main case is timed
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

    own_gen = torch.Generator(device="cuda").manual_seed(20)

    def case(counts, K, N, int4, dtype, main=False, key=None, M=None, w=None, g=gen, wgmma=None):
        counts = torch.tensor(np.asarray(counts), dtype=torch.int32, device="cuda")
        G, routed = counts.numel(), int(counts.sum())
        M = routed if M is None else M
        if w is None:
            lo, hi = (-8, 8) if int4 else (-127, 128)
            w = torch.randint(lo, hi, (G, N, K), device="cuda", generator=g, dtype=torch.int8)
            w = pack_int4(w) if int4 else w
        x = torch.randint(-128, 128, (M, K), device="cuda", generator=g, dtype=torch.int8)
        ws = torch.rand(G, N, device="cuda", generator=g) * 0.01 + 1e-3
        xs = torch.rand(M, 1, device="cuda", generator=g) * 0.05 + 1e-3
        run = lambda: group_quant_gemm.grouped_quant_matmul(x, w, counts, ws, xs, dtype, int4)  # noqa: E731
        active = int((counts > 0).sum())
        out_bytes = torch.finfo(dtype).bits // 8
        # each input read once (the active experts' slabs and scales, x, x's scales, the counts), the output once
        bound = (active * (w.shape[1] * K + 4 * N) + M * (K + 4) + 4 * G + M * N * out_bytes, 2 * routed * K * N,
                 "int8")
        plan = group_quant_gemm.route(M, G, int4)
        if (wgmma or (key and "prefill" in key)) and plan not in group_quant_gemm.PERSISTENT:
            raise AssertionError(f"R's case M={M} G={G} {key or ''} takes the {group_quant_gemm.ROUTE_NAMES[plan]} "
                                 f"route, not wgmma")
        label = (f"grouped quant gemm{' ' + key if key else ''} M={M} K={K} N={N} G={G} ({active} active) "
                 f"{'int4' if int4 else 'int8'} {group_quant_gemm.ROUTE_NAMES[plan]} route")
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
            # the prefill route: a group of three row tiles, groups starting inside another's TMA box, empty groups
            # and an empty tail, N off the tile, K 160
            case([300, 0, 1, 37, 129], 160, 264, int4, dtype, M=500, wgmma=True)
            case(routed_counts(32, 16), 2048, 96, int4, dtype)             # the decode tile, one-row groups
            case([7, 0, 2], 48, 34, int4, dtype)                           # the decode tile, N off its tiles
            # the prefill route at N 34 (its scalar stores) and K 48 (below one 128-byte k slice), and groups that
            # start inside another's box at K 2048, on inputs of their own generator (the cases after phase 3's R
            # cases keep their inputs)
            case([70, 0, 5, 45], 48, 34, int4, dtype, M=130, g=own_gen, wgmma=True)
            case([0, 100, 3, 0, 90, 1, 0], 2048, 256, int4, dtype, M=230, g=own_gen, wgmma=True)
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
    from mojo_opset_tpu_torch.backends.cuda import kernels

    return {cls.__name__: cls.golden_calls for cls in kernels.golden_classes()}


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

    def checker(*dtypes, rounding_ulps=0):
        return _rel_checker(torch, TRAIN_KERNEL_REL_LIMITS, *dtypes, rounding_ulps=rounding_ulps)

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
                key=f"{rows}x{d}", check=checker(dtype, f32, rounding_ulps=TRAIN_KERNEL_ROUNDING_ULPS),
                bound=(3 * n * x.element_size() + 8 * d, 11 * n, "fp32"), library=lib, library_graph=False, note=note)
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
    _k_standing_cases(torch)

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


def _k_standing_cases(torch) -> None:
    """K's standing case: K_STANDING_SHAPES in bf16 on K's generic kernels, each seed of K_STANDING_SEEDS on its own
    generator, held as K's other cases (the ladder, TRAIN_KERNEL_REL_LIMITS with its rounding floor); then whether
    K's dx parts from the plain version's by more than the last rounding to bf16. The same values run again in fp32
    (the same generic kernel: the views are unaligned in both dtypes): K's bf16 dx must equal its fp32 dx rounded
    once, its fp32 dx must lie within K_FP32_GAP_LIMIT of the plain fp32 dx (relative to the RMS), and every bf16
    element where K and the plain version part must differ by one ulp: two fp32 values that close round to
    neighbours only where a rounding boundary lies between them (the two sums' orders split a tie; K is not at
    fault). One line a shape: the parted elements, the readings against the bare limit and the floor, the gap."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import rmsnorm_vjp as kv

    bf16, f32, eps = torch.bfloat16, torch.float32, 1e-6
    check = _rel_checker(torch, TRAIN_KERNEL_REL_LIMITS, bf16, f32, rounding_ulps=TRAIN_KERNEL_ROUNDING_ULPS)
    t0 = time.perf_counter()

    def unaligned(values, dtype):
        """``values`` as a ``dtype`` view one element into its buffer (so not 16-byte aligned)."""
        view = torch.empty(values.numel() + 1, device="cuda", dtype=dtype)[1:].view(values.shape)
        view.copy_(values)
        return view

    for rows, d in K_STANDING_SHAPES:
        parted, readings, floors, gaps = [], [], [], []
        for seed in K_STANDING_SEEDS:
            gen = torch.Generator(device="cuda").manual_seed(2100 + seed)
            xv = torch.randn(rows, d, device="cuda", generator=gen).to(bf16)
            dyv = torch.randn(rows, d, device="cuda", generator=gen).to(bf16)
            w = torch.rand(d, device="cuda", generator=gen) + 0.5
            x, dy = unaligned(xv, bf16), unaligned(dyv, bf16)
            x32, dy32 = unaligned(xv.float(), f32), unaligned(dyv.float(), f32)
            if kv.layout(x, dy, w) is not None or kv.layout(x32, dy32, w) is not None:
                raise AssertionError(f"K's standing case ({rows}, {d}) took the register route")
            got, want = kv.rmsnorm_bwd(x, w, dy, eps), kv.rmsnorm_bwd_plain(x, w, dy, eps)
            check(got, want)
            (dx_k, dx_p), dx_k32, dx_p32 = (got[0], want[0]), kv.rmsnorm_bwd(x32, w, dy32, eps)[0], \
                kv.rmsnorm_bwd_plain(x32, w, dy32, eps)[0]
            if not torch.equal(dx_k, dx_k32.to(bf16)) or not torch.equal(dx_p, dx_p32.to(bf16)):
                raise AssertionError(f"K ({rows}, {d}) seed {seed}: a bf16 dx is not its fp32 dx rounded once")
            gap = (dx_k32.double() - dx_p32.double()).abs().max().item() / dx_p32.double().square().mean().sqrt().item()
            if gap > K_FP32_GAP_LIMIT:
                raise AssertionError(f"K ({rows}, {d}) seed {seed}: fp32 dx {gap:.3g} of the RMS from the plain "
                                     f"version's (limit {K_FP32_GAP_LIMIT})")
            apart = dx_k != dx_p
            kf, pf = dx_k[apart].float(), dx_p[apart].float()
            ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(kf.abs(), pf.abs()))) - 7)  # bf16: 8 bits
            # one ulp, or (a value near 0 whose sign the fp32 gap flips) twice that gap
            beyond = (kf - pf).abs() > torch.maximum(ulp, 2 * (dx_k32 - dx_p32)[apart].abs())
            if bool(beyond.any()):
                raise AssertionError(f"K ({rows}, {d}) seed {seed}: {int(beyond.sum())} bf16 elements part from the "
                                     f"plain version by more than one rounding")
            parted.append(int(apart.sum()))
            readings.append(rel_errors(dx_k, dx_p)[0])
            floors.append(_rounding_floor(torch, dx_p, bf16, TRAIN_KERNEL_ROUNDING_ULPS))
            gaps.append(gap)
        over = [i for i, r in enumerate(readings) if r > TRAIN_KERNEL_REL_LIMITS["bf16"][0]]
        log("kernel rmsnorm_vjp", f"standing case ({rows}, {d}) bf16 unaligned, {len(K_STANDING_SEEDS)} seeds: bf16 "
                                  f"elements parted from the plain version {sum(parted)} of "
                                  f"{rows * d * len(K_STANDING_SEEDS)} (at most {max(parted)} a seed, each one ulp), "
                                  f"dx relative error max {max(readings):.3g}, over the bare limit "
                                  f"{TRAIN_KERNEL_REL_LIMITS['bf16'][0]} on seeds {over} "
                                  f"({[float(f'{readings[i]:.3g}') for i in over]}), each within its rounding floor "
                                  f"(least {min(floors):.3g}); fp32 dx gap over the RMS max {max(gaps):.3g} (limit "
                                  f"{K_FP32_GAP_LIMIT})")
    log("kernel rmsnorm_vjp", f"K's standing cases took {time.perf_counter() - t0:.1f} s")


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
    reduction; timed from a CUDA graph beside the bound and the cuBLAS time of the same product), at the
    vocab-parallel loss's tp 2 and tp 4 shards of it (timed the same way; dz's smoothing over the whole vocabulary,
    the targets shifted by the shard's first row), then fp16 and
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

    def inputs(n, h, v, dtype, ignore_frac=0.25, cfg=None, shard=None):
        cfg = dict(cfg or {})
        x = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(v, h, device="cuda", generator=gen) * 0.02).to(dtype)
        start, vocab = shard or (0, v)  # a vocab shard: the targets drawn over the whole vocabulary, then shifted
        t = torch.randint(0, vocab, (n,), device="cuda", generator=gen, dtype=torch.int32) - start
        t[torch.rand(n, device="cuda", generator=gen) < ignore_frac] = -100
        lse, _, _ = flce.flce_stats_plain(x, w, t, cfg.get("softcap"))
        a, c = flce.backward_coefficients(torch.ones((), device="cuda"), torch.zeros((), device="cuda"), lse, t,
                                          -100, cfg.get("lse_square_scale", 0.0), cfg.get("reduction", "mean"))
        return x, w, t, lse, a, c

    def case(label, n, h, v, dtype, cfg=None, ignore_frac=0.25, main=False, budget=None, shard=None, key=None):
        cfg = dict(cfg or {})
        cap, ls = cfg.get("softcap"), cfg.get("label_smoothing", 0.0)
        vs = None if shard is None else shard[1]  # the whole vocabulary, which the smoothing spreads over
        x, w, t, lse, a, c = inputs(n, h, v, dtype, ignore_frac, cfg, shard)
        isz, kind, ops = x.element_size(), _kind(torch, dtype), 2 * n * h * v
        in_bytes = (n * h + v * h) * isz
        name = f"{label} N={n} H={h} V={v} {cfg or ''}{'' if shard is None else f' shard {shard}'}"
        dz_buf = flce._dz_buffer(n, v, x)
        dw_out = torch.empty_like(w)
        lib = (lambda: x @ w.t()) if main else None  # noqa: E731
        compare("flce_stats", lambda: flce.flce_stats(x, w, t, cap), lambda: flce.flce_stats_plain(x, w, t, cap),
                dtype, "stats " + name, main, check=checker(f32, f32, f32),
                bound=(in_bytes + 4 * n + 12 * n, ops, kind), library=lib, library_graph=False, key=key)
        compare("flce_dz", lambda: flce._dz_kernel(x, w, t, lse, a, c, cap or 0.0, ls, 0, n, dz_buf, vs),
                lambda: flce.flce_dz_plain(x, w, t, lse, a, c, cap, ls, vs), dtype, "dz " + name, main,
                check=checker(dtype), bound=(in_bytes + 16 * n + n * v * isz, ops, kind), library=lib,
                library_graph=False, key=key)
        dz = flce.flce_dz(x, w, t, lse, a, c, cap, ls, vs)
        compare("flce_dx", lambda: flce.flce_dx(dz, w), lambda: flce.flce_dx_plain(dz, w), dtype, "dx " + name, main,
                check=checker(dtype), bound=(n * v * isz + v * h * isz + n * h * isz, ops, kind),
                library=(lambda: dz @ w) if main else None, library_graph=False, key=key)
        compare("flce_dw", lambda: flce._dw_kernel(dz, x, dw_out, None, 0) or dw_out,
                lambda: flce.flce_dw_plain(dz, x), dtype, "dw " + name, main, check=checker(dtype),
                bound=(n * v * isz + n * h * isz + v * h * isz, ops, kind),
                library=(lambda: dz.t() @ x) if main else None, library_graph=False, key=key)
        runs = [(flce.flce_dz(x, w, t, lse, a, c, cap, ls, vs), flce.flce_dx(dz, w), flce.flce_dw(dz, x))
                for _ in range(2)]
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
    # the vocab-parallel loss's shards of the step's lm_head (phase 23): V 75968 at tp 2 (rank 1's rows, the
    # smoothing over the whole vocabulary), 37984 at tp 4; neither V a multiple of 128, so the last V tile is ragged
    case("tp 2 vocab shard", TRAIN_TOKENS, 2560, 151936 // 2, bf16, dict(label_smoothing=0.1), main=True,
         shard=(151936 // 2, 151936), key="vocab_shard_tp2")
    case("tp 4 vocab shard", TRAIN_TOKENS, 2560, 151936 // 4, bf16, main=True, shard=(151936 // 4, 151936),
         key="vocab_shard_tp4")
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
    """16 greedy steps: kernel path == plain path == fused window; the
    kernel path's steps and window replayed from CUDA graphs == eager.

    With ``tie_bound`` (the quantized twins whose activations are int8), the
    kernel and plain paths may part at one step of one row, if there the
    two paths' logits differ by at most ``tie_bound`` and the plain path's
    two best logits lie closer than that difference: a sum in another order
    moved an int8 activation across a rounding tie, and the argmax was a
    near-tie. The fused window must equal the stepwise kernel path. Each
    graphed generator runs twice (its second call replays from its first
    step, and its window replays); the plain twin runs eagerly (its golden
    ops read device values back, which a capture cannot)."""
    from mojo_opset_tpu_torch.runtime import GeneratorHook, GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    class KeepLogits(GeneratorHook):
        def __init__(self):
            self.steps = []

        def after_prefill(self, *, logits, session):
            self.steps.append(logits)

        def after_decode_step(self, *, step, logits, next_token_id):
            self.steps.append(logits)

    def generator(m, hook=None, device_graph=None):
        gm = PagedAttentionGenerationModel(m, block_size=16, device_graph=device_graph,
                                           **({"session_cls": session_cls} if session_cls else {}))
        return MojoGenerator(gm, None, GreedySampler(), max_new_tokens=16, hooks=[hook] if hook else None)

    kept, plain_kept = KeepLogits(), KeepLogits()
    graphed = generator(model, hook=kept)
    graphed.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up: the decode graph is captured
    kept.steps.clear()
    tokens = graphed.generate_from_ids(ids, lens, ignore_eos=True)  # replayed from its first step
    plain_tokens = generator(plain, hook=plain_kept, device_graph=False).generate_from_ids(ids, lens, ignore_eos=True)
    fused_gen = generator(model)
    fused = [fused_gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=True) for _ in range(2)]
    eager = generator(model, device_graph=False)
    eager_tokens = eager.generate_from_ids(ids, lens, ignore_eos=True)
    eager_fused = eager.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=True)
    log(name, f"kernel tokens {tokens.tolist()}")
    for what, got in (("fused window", fused[0]), ("replayed fused window", fused[1]), ("eager stepwise", eager_tokens),
                      ("eager fused window", eager_fused)):
        if not np.array_equal(tokens, got):
            raise AssertionError(f"{name}: {what} tokens differ from the graphed stepwise: {got.tolist()} vs "
                                 f"{tokens.tolist()}")
    if not graphed.model.runners() or graphed.model.runners()[-1].graph is None:
        raise AssertionError(f"{name}: the decode steps never replayed from a graph")
    if np.array_equal(tokens, plain_tokens):
        log(name, "16 greedy steps: kernel path == plain path == fused window; graphs == eager")
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
    log(name, f"16 greedy steps: kernel path == fused window; graphs == eager; {note} (a near-tie, bound "
              f"{tie_bound})")


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
        eager = SpeculativeDecoder(target, draft, k=4, mode="greedy", block_size=16, device_graph=False)
        for run in (spec.generate, spec.generate_fused, eager.generate_fused):
            got = run(ids, lens, max_new_tokens=steps)
            if not np.array_equal(got, want):
                raise AssertionError(f"speculative {run.__name__} with the {name} differs from vanilla greedy: "
                                     f"{got.tolist()} vs {want.tolist()}")
            graphs = "eager" if run.__self__ is eager else "draft rounds and verifies replayed from graphs"
            log("small speculative", f"{name}, {run.__name__} ({graphs}): {steps} tokens x {len(lens)} == vanilla "
                                     f"greedy in {run.__self__.last_rounds} rounds")
        if not all(r.graph is not None for pool in (spec._draft_pool, spec._verify_pool) for r in pool.runners()):
            raise AssertionError(f"speculative decoding with the {name}: a round never replayed from its graph")


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
        "continuous batcher, decode windows of 4": ContinuousBatchingGenerator(
            model, batch_slots=2, block_size=16, max_new_tokens=steps, decode_window=4),
    }
    for name, gen in batchers.items():
        rids = [gen.submit(p) for p in prompts]
        results = gen.run()
        for rid, w in zip(rids, want):
            if not np.array_equal(results[rid], w):
                raise AssertionError(f"{name}: request {rid} gave {results[rid].tolist()}, standalone {w.tolist()}")
        extra = f"; {gen._prefix_owned} blocks held by the prefix cache" if gen.prefix_cache_blocks else ""
        pools = [gen.gm._pool] + ([gen._fused._pool] if gen._fused else []) + (
            [gen.spec._draft_pool, gen.spec._verify_pool] if hasattr(gen, "spec") else [])
        graphs = [r for pool in pools for r in pool.runners() if r.graph is not None]
        if not graphs:
            raise AssertionError(f"{name}: nothing replayed from a graph")
        log("small continuous", f"{name}: {len(prompts)} requests on 2 slots == standalone greedy{extra}; "
                                f"{sum(r.calls - 1 for r in graphs)} replays of {len(graphs)} graphs")
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
                    "R": ("group_quant_gemm_kernel", "group_quant_wgmma_kernel"),
                    "H/R tiles": ("group_tile_table",),
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


# R's launches by route on each quantized MoE path's counted run (prefills and decode steps), by phase tag
R_ROUTES: dict = {}


def _r_routes(tag: str, launched: int) -> None:
    """R's launches by route in the run just counted: the prefills' on a wgmma route, the decode steps' on the
    decode tile, adding up to R's count."""
    from mojo_opset_tpu_torch.backends.cuda.kernels import group_quant_gemm

    routes = dict(group_quant_gemm.launches_by_route)
    log(tag, f"R's launches by route: {routes}")
    wgmma = sum(n for name, n in routes.items() if name.startswith("wgmma"))
    if sum(routes.values()) != launched or not wgmma or not routes.get("decode"):
        raise AssertionError(f"{tag}: R's prefills must run a wgmma route and its decode steps the decode tile, "
                             f"{launched} launches in all: {routes}")
    R_ROUTES[tag] = routes


GRAPH_TURNS = 5  # graph and eager decode steps timed in turns, of each
GRAPH_COSINE_BOUND = 0.99999  # a graph step's logits against the eager step's, where cuBLAS picked another algorithm


def _rewind(session, steps: int = 1) -> None:
    """Take the session's last ``steps`` tokens back: its next step writes the same cache slots again."""
    session.total_seq_lens[:] -= steps


def _fused_windows(torch, tag, model, session, first, out, host_sync_errors: bool) -> tuple:
    """Two FusedDecode windows of FUSED_STEPS on ``session`` from ``first``: the first the window's eager warm-up,
    the second captured and replayed (with ``host_sync_errors`` both under ``no_host_sync``), together equal to
    steps 1..2 * FUSED_STEPS of ``out``; then the second taken back and replayed again, timed, to the same tokens.
    Returns (the windows (B, 2 * FUSED_STEPS), the timed replay's ms a step, its FusedDecode)."""
    from mojo_opset_tpu_torch.runtime import FusedDecode

    fused = FusedDecode(model)
    windows, cur = [], first
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with no_host_sync(torch, model) if host_sync_errors else contextlib.nullcontext():
            window = fused(session, cur, FUSED_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3 / FUSED_STEPS
        windows.append(window)
        cur = window[-1]
        if len(windows) == 2:  # the replay to time starts where the second window did
            _rewind(session, FUSED_STEPS)
            cur = windows[0][-1]
    runner = fused._pool.runners()[-1]
    if runner.graph is None or runner.calls != 3:
        raise AssertionError(f"{tag}: the FusedDecode windows did not replay from their graph")
    if not torch.equal(windows[2], windows[1]):
        raise AssertionError(f"{tag}: a FusedDecode window replayed from the same state gave other tokens")
    windows = torch.cat(windows[:2]).T.cpu().numpy()
    if not np.array_equal(windows, out[:, 1:2 * FUSED_STEPS + 1]):
        raise AssertionError(f"FusedDecode tokens {windows.tolist()} differ from stepwise {out[:, 1:].tolist()}")
    what = "with host syncs as errors; " if host_sync_errors else ""
    log(tag, f"FusedDecode windows ({FUSED_STEPS} steps: its warm-up, then captured in {runner.capture_ms:.1f} ms "
             f"and replayed, then replayed again from the same state) ran {what}== stepwise")
    return windows, ms, fused


def _eager_check(torch, tag, model, ids, lens, out, windows, **gm_kw):
    """The same path with device_graph=False: its prefill, DECODE_STEPS greedy steps and two FusedDecode windows
    give the graphs' tokens ``out`` and ``windows``. Returns the eager model wrapper."""
    from mojo_opset_tpu_torch.runtime import FusedDecode, GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    gm_e = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE, device_graph=False, **gm_kw)
    eager = MojoGenerator(gm_e, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1).generate_from_ids(
        ids, lens, ignore_eos=True)
    if not np.array_equal(eager, out):
        raise AssertionError(f"{tag}: graphed tokens {out.tolist()} differ from eager {eager.tolist()}")
    _, session = gm_e(ids, context_input_len=lens)
    fused = FusedDecode(model, device_graph=False)
    first = fused(session, torch.as_tensor(eager[:, 0], device="cuda"), FUSED_STEPS)
    eager_windows = torch.cat([first, fused(session, first[-1], FUSED_STEPS)]).T.cpu().numpy()
    if not np.array_equal(eager_windows, windows):
        raise AssertionError(f"{tag}: graphed FusedDecode windows {windows.tolist()} differ from eager "
                             f"{eager_windows.tolist()}")
    log(tag, f"device_graph=False gives the graphs' tokens: prefill, {DECODE_STEPS} steps and both windows")
    return gm_e


def _graph_vs_eager(torch, tag, card, gm, gm_e, session, token, per_step: dict) -> dict:
    """One decode step of ``session`` from its graph (its warm-up already run, counted in ``per_step``) and from
    the eager ``gm_e``, each step taken back after it, so all see one state: the replayed step counts
    ``per_step``'s launches; its logits equal the eager step's bit for bit, or else per-row cosine >=
    GRAPH_COSINE_BOUND (the difference printed); GRAPH_TURNS steps of each timed in turns; one graph step
    profiled (device busy, idle share of its wall); capture ms and the graph pool's memory. Returns the
    readings."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels

    def step(m):
        logits, _ = m(token, session=session)
        _rewind(session)
        return logits

    step(gm)  # captured here, then replayed
    runner = gm.runners()[-1]
    if runner.graph is None:
        raise AssertionError(f"{tag}: the decode step was not captured")
    kernels.reset_launch_counts()
    graph_logits = step(gm)
    replayed = {k: v for k, v in kernels.launch_counts().items() if v}
    if replayed != per_step:
        raise AssertionError(f"{tag}: a replayed step counts {replayed}, its eager warm-up {per_step}")
    eager_logits = step(gm_e)
    if torch.equal(graph_logits, eager_logits):
        same = "equal bit for bit"
    else:
        cos = torch.nn.functional.cosine_similarity(graph_logits.float(), eager_logits.float(), dim=-1)
        diff = (graph_logits.float() - eager_logits.float()).abs().max().item()
        same = f"not equal bit for bit: max |diff| {diff:.4g}, per-row cosine {cos.tolist()}"
        if cos.min().item() < GRAPH_COSINE_BOUND:
            raise AssertionError(f"{tag}: the graph step's logits part from the eager step's: {same}")
    times = {"graph": [], "eager": []}
    for _ in range(GRAPH_TURNS):
        for name, m in (("graph", gm), ("eager", gm_e)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(m)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(gm)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    step(gm)
    end.record()
    torch.cuda.synchronize()
    span = start.elapsed_time(end)
    graph_ms, eager_ms = (float(np.median(times[k])) for k in ("graph", "eager"))
    pool_mib = gm._pool.memory_bytes() / 2**20
    log(tag, f"{card}: decode step in turns ({GRAPH_TURNS} of each, bs {session.batch_size}): graph ms "
             f"{times['graph']}, eager ms {times['eager']}; median graph {graph_ms:.3f} ms, eager {eager_ms:.3f} ms "
             f"({eager_ms / graph_ms:.2f}x), host ms a step the graph saves {eager_ms - graph_ms:.3f}; graph step "
             f"profiled: device busy {busy:.3f} ms in {sum(e.count for e in device)} kernels, idle "
             f"{100 * (1 - busy / graph_ms):.1f}% of its median wall; its device span (CUDA events) {span:.3f} ms; "
             f"capture {runner.capture_ms:.1f} ms; the decode graph pool holds {pool_mib:.1f} MiB; one step's "
             f"logits graph vs eager: {same}; a replayed step counts {replayed}")
    return {"graph_ms": graph_ms, "eager_ms": eager_ms, "busy_ms": busy, "capture_ms": runner.capture_ms,
            "pool_mib": pool_mib}


def _serve_and_check(torch, tag: str, model, plain, ids, lens, path_kernels, card: str, reference=None,
                     cosine_bound: float = 0.999, host_sync_errors: bool = False, step_families=()):
    """Phase 5's run for one model and its plain twin, its decode on CUDA
    graphs (the entry points' default): prefill, DECODE_STEPS greedy steps
    (the generator's second call, replayed from its first step) and two
    FusedDecode windows (``_fused_windows``; with ``host_sync_errors`` under
    ``no_host_sync``) with the counters zeroed just before and read just
    after (every kernel of ``path_kernels`` must launch); the same with
    device_graph=False, token for token (``_eager_check``); one more decode
    step counted (its graph's eager warm-up), then one eager step profiled
    (with the device ms and share of busy of each PREFILL_FAMILIES kernel
    named in ``step_families``) and ``_graph_vs_eager`` on that session;
    and the last-token prefill logits against the plain path (per-row
    cosine >= ``cosine_bound``; against ``reference`` printed with no
    bound). Peak memory counts from the caller's last reset. Returns
    (counts, logits, session)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook

    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
    if not gm.device_graph:
        raise AssertionError(f"{tag}: the entry point does not serve on graphs by default")
    hook = PerfHook(silent=True)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=DECODE_STEPS + 1, hooks=[hook])
    gen.generate_from_ids(ids, lens, ignore_eos=True)  # warm-up: allocator, cuBLAS handles, the decode graph
    kernels.reset_launch_counts()
    out = gen.generate_from_ids(ids, lens, ignore_eos=True)
    logits, session = gm(ids, context_input_len=lens)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    windows, fused_ms, _ = _fused_windows(torch, tag, model, session, first, out, host_sync_errors)
    counts = {k: v for k, v in kernels.launch_counts().items() if k in path_kernels}
    log(tag, f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the {tag} path never launched: {counts}")
    if "group_quant_gemm" in counts:
        _r_routes(tag, counts["group_quant_gemm"])
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    gm_e = _eager_check(torch, tag, model, ids, lens, out, windows)

    token = torch.as_tensor(windows[:, -1], device="cuda")
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = {k: v for k, v in kernels.launch_counts().items() if v}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm_e(token, session=session)
        torch.cuda.synchronize()
    _rewind(session)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    shares = "".join(
        f"; {f} {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)" for f, ms in (
            (f, sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES[f])) / 1e3)
            for f in step_families))
    log(tag, f"{card}: one eager decode step (bs 4, context ~1050): {sum(e.count for e in device)} device kernels, "
             f"the port's kernels {per_step}; device busy {busy:.3f} ms{shares}")
    _graph_vs_eager(torch, tag, card, gm, gm_e, session, token, per_step)

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
             f"{rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise on graphs, "
             f"{rec['decode_steps']} steps, each read back); FusedDecode {fused_ms:.3f} ms/step, "
             f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s (the replayed window); peak memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
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
    a bf16 Qwen3-4B target (depth SPEC_LAYERS) and its w4a8 twin as the draft, k = 4. Returns the
    path's launches and G's by route and M."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import (
        GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook, SpeculativeDecoder,
    )

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    target = Qwen3ForCausalLM(Qwen3Config(**dict(QWEN3_4B, num_hidden_layers=SPEC_LAYERS), dtype=torch.bfloat16),
                              device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    draft, plain_draft = _quantized_pair(torch, target, quant_kv=False, weight_dtype="int4")
    int4_bytes = sum(m.weight.numel() for m in draft.modules() if getattr(m, "weight_dtype", None) == "int4")
    int8_bytes = sum(m.weight.numel() for m in draft.modules() if getattr(m, "weight_dtype", None) == torch.int8)
    log("w4a8 speculative", f"bf16 Qwen3-4B target (depth cut {QWEN3_4B['num_hidden_layers']} -> {SPEC_LAYERS}) "
                            f"and its w4a8 draft, quantized on the card in "
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
    # warm-up: the decode graph, the window's graph (its first call is its eager warm-up, its second captures), the
    # draft round's and the verify's graphs
    gen.generate_from_ids(ids, lens, ignore_eos=True)
    for _ in range(2):
        gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=True)
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
    _speculative_turns(torch, card, target, draft, gen, spec, ids, lens, vanilla, spec_fused, prefill_s)
    del target, draft, spec, gm, gen
    torch.cuda.empty_cache()
    return counts, by_route


def _speculative_turns(torch, card, target, draft, gen, spec, ids, lens, vanilla, spec_fused, prefill_s) -> None:
    """Phase 7's pair on graphs against device_graph=False: the same tokens; then GRAPH_TURNS runs of each, in
    turns, of vanilla stepwise decoding and of fused speculative decoding, ms/token; one graphed speculative run
    profiled (device busy, idle share of its wall); the draft round's and the verify's capture ms and pool memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook
    from mojo_opset_tpu_torch.runtime import SpeculativeDecoder

    hook_e = PerfHook(silent=True)
    gen_e = MojoGenerator(PagedAttentionGenerationModel(target, block_size=BLOCK_SIZE, device_graph=False), None,
                          GreedySampler(), max_new_tokens=SPEC_NEW, hooks=[hook_e])
    spec_e = SpeculativeDecoder(target, draft, k=SPEC_K, mode="greedy", block_size=BLOCK_SIZE, device_graph=False)
    for what, got, want in (("vanilla", gen_e.generate_from_ids(ids, lens, ignore_eos=True)[0], vanilla),
                            ("speculative", spec_e.generate_fused(ids, lens, max_new_tokens=SPEC_NEW)[0],
                             spec_fused)):
        if not np.array_equal(got, want):
            raise AssertionError(f"{what} decoding with device_graph=False gives {got.tolist()}, on graphs "
                                 f"{want.tolist()}")
    times = {name: [] for name in ("vanilla graph", "vanilla eager", "speculative graph", "speculative eager")}

    def speculative(decoder):
        torch.cuda.synchronize()
        t = time.perf_counter()
        decoder.generate_fused(ids, lens, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t) - prefill_s) * 1e3 / SPEC_NEW

    for _ in range(GRAPH_TURNS):
        for name, g in (("vanilla graph", gen), ("vanilla eager", gen_e)):
            g.generate_from_ids(ids, lens, ignore_eos=True)
            times[name].append(g._hooks[0].records[-1]["decode_avg_ms"])
        times["speculative graph"].append(speculative(spec))
        times["speculative eager"].append(speculative(spec_e))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        spec.generate_fused(ids, lens, max_new_tokens=SPEC_NEW)
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / 1e3
    med = {name: float(np.median(v)) for name, v in times.items()}
    wall = med["speculative graph"] * SPEC_NEW + prefill_s * 1e3  # an unprofiled run, its prefill included
    pools = {"draft round": spec._draft_pool, "verify": spec._verify_pool}
    captures = "; ".join(f"{name} capture {pool.runners()[-1].capture_ms:.1f} ms, pool "
                         f"{pool.memory_bytes() / 2**20:.1f} MiB" for name, pool in pools.items())
    log("w4a8 speculative", f"{card}: in turns ({GRAPH_TURNS} of each, bs 1, {SPEC_NEW} new tokens), ms/token: "
                            + "; ".join(f"{name} {v}" for name, v in times.items()) + "; medians "
                            + ", ".join(f"{name} {v:.3f}" for name, v in med.items())
                            + f"; speculative on graphs {med['speculative eager'] / med['speculative graph']:.2f}x "
                              f"its eager run and {med['vanilla graph'] / med['speculative graph']:.2f}x vanilla on "
                              f"graphs; one graphed speculative run profiled (prefill included): device busy "
                              f"{busy:.3f} ms, {busy / SPEC_NEW:.3f} ms a token, idle {100 * (1 - busy / wall):.1f}% "
                              f"of an unprofiled run's wall ({wall:.3f} ms from the median); {captures}")


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
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook
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
    windows, fused_ms, _ = _fused_windows(torch, "moe full width", model, session, first, out, True)
    counts = {k: v for k, v in kernels.launch_counts().items() if k in MOE_PATH_KERNELS}
    log("moe full width", f"launches on the main path: {counts}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the MoE path never launched: {counts}")
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    gm_e = _eager_check(torch, "moe full width", model, ids, lens, out, windows)

    # one more decode step (its graph's eager warm-up): grouped GEMM launches per step, then an eager step profiled
    # and the graph step against the eager one
    token = torch.as_tensor(windows[:, -1], device="cuda")
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = {k: v for k, v in kernels.launch_counts().items() if v}
    if per_step["group_gemm"] != 2 * config.num_hidden_layers:
        raise AssertionError(f"group_gemm launched {per_step['group_gemm']} times in a decode step, not "
                             f"{2 * config.num_hidden_layers}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm_e(token, session=session)
        torch.cuda.synchronize()
    _rewind(session)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = max(sum(e.self_device_time_total for e in device) / 1e3, 1e-9)
    n_kernels = sum(e.count for e in device)
    gmm = sum(e.self_device_time_total for e in device if "gmm_" in e.key) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    log("moe full width", f"{card}: one eager decode step (bs 4, context ~1050): device busy {busy:.3f} ms, "
                          f"{n_kernels} kernels; group_gemm {gmm:.3f} ms ({100 * gmm / busy:.1f}% of busy, "
                          f"{per_step['group_gemm']} launches)")
    log("moe full width", "device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    _graph_vs_eager(torch, "moe full width", card, gm, gm_e, session, token, per_step)

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
                          f"decode {rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise on "
                          f"graphs, {rec['decode_steps']} steps); FusedDecode {fused_ms:.3f} ms/step (replayed), "
                          f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak memory "
                          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log("moe full width", f"tokens of request 3 (7-token prompt): {out[3].tolist()}")
    _prefill_profile(torch, "moe full width", card, gm, ids, lens)
    del plain, gm, gm_e, gen, session, mlp_in, routes, plain_routes
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
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, PerfHook
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
    windows, fused_ms, _ = _fused_windows(torch, tag, model, session, first, out, True)
    counts = kernels.launch_counts()
    log(tag, f"launches on the main path: {counts}")
    if min(counts[k] for k in path_kernels) <= 0:
        raise AssertionError(f"a kernel of the {tag} path never launched: {counts}")
    if "group_quant_gemm" in path_kernels:
        _r_routes(tag, counts["group_quant_gemm"])
    if counts["paged_decode"] or counts["paged_prefill"]:
        raise AssertionError(f"the GQA attention kernels launched on the MLA path: {counts}")
    if out.shape != (len(PROMPT_LENS), DECODE_STEPS + 1):
        raise AssertionError(f"generated ids shape {out.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite prefill logits")
    gm_e = _eager_check(torch, tag, model, ids, lens, out, windows, session_cls=MLARuntimeState)

    # one more decode step (its graph's eager warm-up): launches per step, and one layer's MLA decode held to the
    # golden op on its cache
    token = torch.as_tensor(windows[:, -1], device="cuda")
    op = model.model.layers[DEEPSEEK_LAYER_CHECKED].self_attn.attn_decode
    seen = []
    seen_hook = op.register_forward_pre_hook(lambda mod, args: seen.append(args))
    kernels.reset_launch_counts()
    gm(token, session=session)
    per_step = kernels.launch_counts()
    seen_hook.remove()
    if not seen:
        raise AssertionError(f"{tag}: the decode step's warm-up did not run the MLA op eagerly")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        gm_e(token, session=session)
        torch.cuda.synchronize()
    _rewind(session)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = max(sum(e.self_device_time_total for e in device) / 1e3, 1e-9)
    n_kernels = sum(e.count for e in device)
    mla = sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES["I"])) / 1e3
    fam = "R" if experts_kernel == "group_quant_gemm" else "H"
    moe = sum(e.self_device_time_total for e in device if any(p in e.key for p in PREFILL_FAMILIES[fam])) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    log(tag, f"{card}: one eager decode step (bs 4, context ~1050): device busy {busy:.3f} ms, {n_kernels} kernels; "
             f"mla_decode {mla:.3f} ms ({100 * mla / busy:.1f}% of busy, {per_step['mla_decode']} launches); "
             f"{experts_kernel} {moe:.3f} ms ({100 * moe / busy:.1f}%, {per_step[experts_kernel]} launches)")
    log(tag, "device time by kernel: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    _graph_vs_eager(torch, tag, card, gm, gm_e, session, token, {k: v for k, v in per_step.items() if v})

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
             f"{rec['decode_avg_ms']:.3f} ms/step, {rec['throughput']:.1f} tok/s (stepwise on graphs, "
             f"{rec['decode_steps']} steps); FusedDecode {fused_ms:.3f} ms/step (replayed), "
             f"{len(PROMPT_LENS) * 1e3 / fused_ms:.1f} tok/s; peak memory "
             f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
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
    """Seed-OSS at Seed-OSS-36B widths, depth cut to 16: the bf16 model on A-D
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
    and final latents against the plain twin, (b)'s clip against (a)'s. Returns (b)'s launches, and the model with
    its plain twin, which phase 16 takes over rather than build them again."""
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
    gc.collect()
    torch.cuda.empty_cache()
    return runs["(b) ragged clip + image"][1], [model, plain]


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


def _rounding_floor(torch, want, dtype, ulps: int) -> float:
    """``ulps`` roundings to ``dtype`` of ``want``'s largest element, relative to ``want``'s norm: what that many
    elements parted by one ulp can read (an ulp is at most eps times the value)."""
    w = want.double()
    norm = w.norm().item()
    return ulps * torch.finfo(dtype).eps * w.abs().max().item() / norm if norm else 0.0


def _rel_checker(torch, limits: dict, *dtypes, rounding_ulps: int = 0):
    """A ``compare`` check: each output of the dtype's type and shape, to its dtype's ladder, then relative to its
    size to ``limits`` (by operand kind: whole tensor, worst row); with ``rounding_ulps``, the whole-tensor limit no
    lower than that many roundings of the output's largest element (``_rounding_floor``)."""
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
            if rounding_ulps:
                limit = (max(limit[0], _rounding_floor(torch, w, dt, rounding_ulps)), limit[1])
            if not (whole <= limit[0] and row <= limit[1]):
                raise AssertionError(f"relative error {whole:.3g} (worst row {row:.3g}) over limit {limit} for an "
                                     f"output of RMS {rms:.3g}")
            notes.append(f"{tols_for(dt)}, relative {whole:.3g}, worst row {row:.3g} (limit ({limit[0]:.3g}, "
                         f"{limit[1]:.3g})), rms {rms:.3g}")
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


def _cudnn_flags(torch, tf32: bool):
    """cuDNN on, deterministic, no autotuning, its fp32 convolutions in TF32 (PyTorch's own default, which
    phase_device turned off for the run) or in full fp32: the VAE's precision, set around its calls."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=tf32)


def _vae_rel(torch, got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def _wan_t2v_small_check(torch) -> int:
    """A small fp32 umT5 encoder (T5_SMALL) and VAE (VAE_SMALL) built on the CPU and on the card from the same numpy
    weights: the encoder's states on a padded batch of two, the VAE's encode of 5 frames and its decode, the card's
    against the CPU port's within the fp32 rung of utils/acc.py, the VAE's convolutions with TF32 allowed (PyTorch's
    default) and in full fp32. Returns the two encodes' golden CudaSdpa calls (the CPU's are counted too)."""
    from mojo_opset_tpu_torch.modeling.wan2_2 import T5Encoder, WanVAE_
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for
    from mojo_opset_tpu_torch.utils.weights import load_numpy_state, random_numpy_state

    tol = tols_for(torch.float32)
    cfg = dict(T5_SMALL)
    vocab = cfg.pop("vocab")
    cpu_enc = T5Encoder(vocab, **cfg, device="cpu")
    weights = random_numpy_state(cpu_enc, seed=16)
    load_numpy_state(cpu_enc, weights)
    enc = load_numpy_state(T5Encoder(vocab, **cfg, device="cuda"), weights)
    gen = torch.Generator().manual_seed(16)
    ids = torch.randint(1, vocab, (2, 40), generator=gen)
    mask = (torch.arange(40)[None, :] < torch.tensor([[40], [17]])).to(torch.int32)
    ids = ids * mask
    with torch.inference_mode():
        want = cpu_enc(ids, mask)
        got = enc(ids.cuda(), mask.cuda())
    check_tol_diff(got, want, **tol)
    log("wan t2v", f"small fp32 umT5 ({cfg['num_layers']} layers, dim {cfg['dim']}) on a padded batch (40 and 17 "
                   f"tokens): card vs CPU max_abs_err {(got.cpu() - want).abs().max().item():.3g} (tol {tol})")

    cpu_vae = WanVAE_(**VAE_SMALL, device="cpu")
    weights = random_numpy_state(cpu_vae, seed=17)
    load_numpy_state(cpu_vae, weights)
    vae = load_numpy_state(WanVAE_(**VAE_SMALL, device="cuda"), weights)
    video = torch.rand(1, 3, 5, 64, 64, generator=gen) * 2 - 1
    with torch.inference_mode():
        want_mu = cpu_vae.encode(video)
        want_video = cpu_vae.decode(want_mu)
        for tf32 in (True, False):
            with _cudnn_flags(torch, tf32):
                mu = vae.encode(video.cuda()).cpu()
                out = vae.decode(want_mu.cuda()).cpu()
            check_tol_diff(mu, want_mu, **tol)
            check_tol_diff(out, want_video, **tol)
            log("wan t2v", f"small fp32 VAE (dim {VAE_SMALL['dim']}, z {VAE_SMALL['z_dim']}), 5 frames of 64 x 64, "
                           f"{'TF32 convolutions' if tf32 else 'full fp32'}: card vs CPU, latent max_abs_err "
                           f"{(mu - want_mu).abs().max().item():.3g} (relative {_vae_rel(torch, mu, want_mu):.3g}), "
                           f"video {(out - want_video).abs().max().item():.3g} (relative "
                           f"{_vae_rel(torch, out, want_video):.3g}); within the fp32 rung {tol}")
    del cpu_enc, enc, cpu_vae, vae
    return 2 * cfg["num_layers"]


def phase_wan_t2v(torch, card: str, dit: list) -> dict:
    """Phase 16: Wan2.2's text -> DiT -> video path on the card. A small fp32 twin check first; then umT5-xxl at
    full width and depth in bf16 (random weights from seed 0) encodes two requests (T5_REQUEST_LENS) padded to 512
    tokens: each request's rows against that request encoded alone (per-row cosine >= T5_ROW_COSINE_BOUND), and
    exactly 24 golden CudaSdpa calls an encode (the additive bias takes the golden, as in JAX's Pallas tier); the
    96-token context feeds phase 12's Wan2.2-TI2V-5B DiT (``dit``: the model and its plain twin, taken over, not
    built again, and emptied here: both are freed once the steps are done) for WAN_T2V_STEPS Euler steps of the clip
    latents from seeded noise (A and J launches exact, the first velocity against the plain twin); the final latents
    go through Wan2.2's VAE (WAN_VAE, its convolutions in TF32: PyTorch's default) to a (3, 17, 704, 1280) video in
    [-1, 1] whose first frame is the first latent frame decoded alone, timed again in full fp32; a seeded 704 x 1280
    image encodes to the TI2V image request's (48, 1, 44, 80) latent. Peak memory is reported above what was
    allocated when each stage began. No other golden route may be taken. Returns the DiT steps' launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaSdpa
    from mojo_opset_tpu_torch.benchmark.dit_protocol import PerfDiTRunner
    from mojo_opset_tpu_torch.modeling.wan2_2 import T5EncoderModel, Wan2_2_VAE, WanVAE_, umt5_xxl_encoder

    t_phase = time.perf_counter()
    golden0 = golden_counts()
    goldens = _wan_t2v_small_check(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # umT5-xxl
    t0 = time.perf_counter()
    model, plain = dit
    dit.clear()
    text_len = model.cfg.text_len
    t5_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    encoder = umt5_xxl_encoder(device="cuda", dtype=torch.bfloat16,
                               generator=torch.Generator(device="cuda").manual_seed(0))
    layers = len(encoder.blocks)
    vocab = encoder.token_embedding.num_embeddings
    log("wan t2v", f"umT5-xxl: {sum(p.numel() for p in encoder.parameters()) / 1e9:.3f} B params bf16, {layers} "
                   f"layers, dim {encoder.token_embedding.embedding_dim}, vocabulary {vocab}; built in "
                   f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    lens = torch.tensor(T5_REQUEST_LENS, device="cuda")
    mask = (torch.arange(text_len, device="cuda")[None, :] < lens[:, None]).to(torch.int32)
    ids = torch.randint(1, vocab, (len(T5_REQUEST_LENS), text_len), device="cuda", generator=gen) * mask
    t5 = T5EncoderModel(encoder)
    with torch.inference_mode():
        before = CudaSdpa.golden_calls
        context = t5(ids, mask)  # also the warm-up
        if CudaSdpa.golden_calls - before != layers:
            raise AssertionError(f"an umT5-xxl encode took {CudaSdpa.golden_calls - before} golden CudaSdpa calls, "
                                 f"want {layers}")
        iters = 3
        encode_ms = cuda_ms(torch, lambda: encoder(ids, mask), iters=iters, warmup=0)
        alone = [encoder(ids[i:i + 1, :n], mask[i:i + 1, :n])[0] for i, n in enumerate(T5_REQUEST_LENS)]
        t5_peak = (torch.cuda.max_memory_allocated() - t5_base) / 2**30
    goldens += layers * (1 + iters + len(T5_REQUEST_LENS))
    cos_rows = [torch.nn.functional.cosine_similarity(c.double(), a.double(), dim=-1).min().item()
                for c, a in zip(context, alone)]
    if any(c.shape != (n, encoder.token_embedding.embedding_dim) or not torch.isfinite(c).all()
           for c, n in zip(context, T5_REQUEST_LENS)):
        raise AssertionError("umT5-xxl: a context of the wrong shape, or not finite")
    log("wan t2v", f"{card}: umT5-xxl encode of {len(T5_REQUEST_LENS)} x {text_len} padded tokens ({T5_REQUEST_LENS} "
                   f"valid): {encode_ms:.2f} ms (CUDA events, mean of {iters}), "
                   f"{len(T5_REQUEST_LENS) * text_len / encode_ms * 1e3:.0f} padded tokens/s "
                   f"({sum(T5_REQUEST_LENS) / encode_ms * 1e3:.0f} valid); {layers} golden CudaSdpa calls an encode "
                   f"(the float bias); peak memory above the stage's start (the encoder's weights included) "
                   f"{t5_peak:.2f} GiB; each request's rows against it encoded alone: least per-row cosine "
                   f"{[round(c, 6) for c in cos_rows]} (bound {T5_ROW_COSINE_BOUND})")
    if min(cos_rows) < T5_ROW_COSINE_BOUND:
        raise AssertionError(f"umT5-xxl: a request's rows in the batch part from it encoded alone: {cos_rows}")
    text = context[0].clone()
    del encoder, t5, context, alone
    gc.collect()
    torch.cuda.empty_cache()

    # text -> DiT
    L = model.cfg.num_layers
    seq_len = WAN_CLIP[1] * (WAN_CLIP[2] // 2) * (WAN_CLIP[3] // 2)
    noise = [torch.randn(WAN_CLIP, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))]
    dit_golden = golden_counts()
    with torch.inference_mode():
        kernels.reset_launch_counts()
        first, final, step_ms = PerfDiTRunner(model).denoise(noise, [text], seq_len, WAN_T2V_STEPS)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        plain_first, _, _ = PerfDiTRunner(plain).denoise(noise, [text], seq_len, 1)
    want = {"norms": 4 * L * WAN_T2V_STEPS, "flash_swa_fwd": 2 * L * WAN_T2V_STEPS}
    if counts != want:
        raise AssertionError(f"wan t2v: the DiT steps launched {counts}, want {want}")
    if golden_counts() != dit_golden:
        raise AssertionError("wan t2v: a golden route was taken on the DiT's steps")
    cos_v = _cosine(torch, first[0], plain_first[0])
    if not (torch.isfinite(first[0]).all() and torch.isfinite(final[0]).all()) or cos_v < WAN_COSINE_BOUND:
        raise AssertionError(f"wan t2v: the velocity on the text context is not finite or parts from the plain "
                             f"twin: cosine {cos_v}")
    log("wan t2v", f"{card}: Wan2.2-TI2V-5B (phase 12's model) on the {T5_REQUEST_LENS[0]}-token umT5 context, "
                   f"{WAN_T2V_STEPS} Euler steps of {WAN_CLIP}: {step_ms:.2f} ms/step (CUDA events); launches "
                   f"{counts}; first velocity cosine vs the plain twin {cos_v:.6f} (bound {WAN_COSINE_BOUND})")
    latents = final[0]
    del first, final, plain_first, noise, model, plain
    gc.collect()
    torch.cuda.empty_cache()

    # the VAE: decode the latents, time it with TF32 convolutions, decode the first latent frame alone, encode an
    # image; then the decode in full fp32
    t0 = time.perf_counter()
    vae_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vae = Wan2_2_VAE(vae=WanVAE_(**WAN_VAE, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0)),
                     z_dim=WAN_VAE["z_dim"])
    vae_params = sum(p.numel() for p in vae.model.parameters())
    log("wan t2v", f"Wan2.2 VAE {WAN_VAE}: {vae_params / 1e6:.1f} M params fp32, built in "
                   f"{time.perf_counter() - t0:.1f} s")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_ms(fn):
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    with torch.inference_mode():
        with _cudnn_flags(torch, True):
            tf32_on = torch.backends.cudnn.allow_tf32
            video, decode_ms = timed_ms(lambda: vae.decode([latents])[0])
            vae_peak = (torch.cuda.max_memory_allocated() - vae_base) / 2**30
            lone, _ = timed_ms(lambda: vae.decode([latents[:, :1]])[0])
            image = torch.rand(3, 1, *WAN_VIDEO[2:], device="cuda",
                               generator=torch.Generator(device="cuda").manual_seed(4))
            image_latent, encode_ms = timed_ms(lambda: vae.encode([image * 2 - 1])[0])
        with _cudnn_flags(torch, False):
            tf32_off = not torch.backends.cudnn.allow_tf32
            video_fp32, fp32_ms = timed_ms(lambda: vae.decode([latents])[0])
    if not (tf32_on and tf32_off):
        raise AssertionError("wan t2v: cudnn.flags did not set the convolutions' TF32 as asked")
    if tuple(video.shape) != WAN_VIDEO or not torch.isfinite(video).all() or video.abs().max().item() > 1.0:
        raise AssertionError(f"wan t2v: the video is {tuple(video.shape)}, want {WAN_VIDEO}, finite, in [-1, 1]")
    same = torch.equal(lone[:, 0], video[:, 0])
    cos_first = _cosine(torch, lone[:, 0], video[:, 0])
    if not same and cos_first < VAE_CAUSAL_COSINE_BOUND:
        raise AssertionError(f"wan t2v: the first frame parts from the first latent frame decoded alone: cosine "
                             f"{cos_first}")
    if tuple(image_latent.shape) != WAN_IMAGE or not torch.isfinite(image_latent).all():
        raise AssertionError(f"wan t2v: the image latent is {tuple(image_latent.shape)}, want {WAN_IMAGE}")
    cos_fp32 = _cosine(torch, video, video_fp32)
    log("wan t2v", f"{card}: VAE decode of {tuple(latents.shape)} to {tuple(video.shape)}, TF32 convolutions "
                   f"(PyTorch's default): {decode_ms:.1f} ms (CUDA events), {WAN_VIDEO[1] / decode_ms * 1e3:.2f} video "
                   f"frames/s, peak memory above the stage's start (the VAE's weights included) {vae_peak:.2f} GiB; "
                   f"in full fp32 {fp32_ms:.1f} ms, "
                   f"{WAN_VIDEO[1] / fp32_ms * 1e3:.2f} frames/s; the two videos' cosine {cos_fp32:.8f}, max_abs_err "
                   f"{(video - video_fp32).abs().max().item():.3g}; video in "
                   f"[{video.min().item():.3f}, {video.max().item():.3f}]; the first frame against the first latent "
                   f"frame decoded alone (cuDNN deterministic): {'bit for bit' if same else 'not bit for bit'}, "
                   f"cosine {cos_first:.8f} (bound {VAE_CAUSAL_COSINE_BOUND}), max_abs_err "
                   f"{(lone[:, 0] - video[:, 0]).abs().max().item():.3g}")
    log("wan t2v", f"{card}: VAE encode of a {WAN_VIDEO[2]} x {WAN_VIDEO[3]} image to {tuple(image_latent.shape)}, "
                   f"TF32 convolutions: {encode_ms:.1f} ms (CUDA events)")
    after = golden_counts()
    moved = {k: after[k] - golden0[k] for k in after if after[k] != golden0[k]}
    if moved != {"CudaSdpa": goldens}:
        raise AssertionError(f"wan t2v: golden routes {moved}, want only CudaSdpa's {goldens} (the T5 encodes)")
    log("wan t2v", f"golden routes: CudaSdpa {goldens} ({layers} an umT5-xxl encode, {T5_SMALL['num_layers']} a "
                   f"small one), no other; phase {time.perf_counter() - t_phase:.1f} s")
    del vae, video, video_fp32, lone, image, image_latent
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _paged_state(torch, batch, hkv, d, bs, max_blocks, dtype):
    """Empty caches (N, Hkv, bs, D) and a block table giving each sequence its own blocks (JAX's capture suite)."""
    n_blocks = batch * max_blocks + 2
    caches = [torch.zeros((n_blocks, hkv, bs, d), dtype=dtype, device="cuda") for _ in range(2)]
    table = torch.arange(batch * max_blocks, dtype=torch.int32, device="cuda").reshape(batch, max_blocks)
    return caches, table


def _slots(torch, table, lens, bs):
    """The KV store's (block, row) of each sequence's new token at ``lens``, on the device."""
    blocks = torch.gather(table, 1, (lens // bs).long()[:, None])[:, 0]
    return blocks.long(), (lens % bs).long()


def _replay_matches_eager(torch, name, step, init, inputs) -> None:
    """``step(state, *inputs[t])`` (a store and a decode into the donated ``state``) for each t: eagerly on one
    state, and through a CompiledStepPool on another (its warm-up, its capture, then replays of one graph);
    every output equal bit for bit, as JAX's suite holds them to rtol = atol = 1e-5."""
    from mojo_opset_tpu_torch.runtime import CompiledStepPool

    eager_state, graph_state = init(), init()
    pool = CompiledStepPool(step, donate_argnums=(0,), name=name)
    with torch.inference_mode():
        want = [step(eager_state, *x) for x in inputs]
        got = [pool.get_runner(graph_state, *x)(graph_state, *x) for x in inputs]
    for t, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: replayed step {t} differs from eager: max |diff| "
                                 f"{(g.float() - w.float()).abs().max().item():.4g}")
    runner = pool.runners()[0]
    if len(pool.runners()) != 1 or runner.calls != len(inputs) or runner.graph is None:
        raise AssertionError(f"{name}: {len(pool.runners())} graphs, {runner.calls} calls: not one replayed graph")
    log("capture", f"{name}: {len(inputs)} steps (warm-up, capture in {runner.capture_ms:.1f} ms, "
                   f"{len(inputs) - 2} more replays) equal to eager bit for bit")


def phase_capture(torch) -> None:
    """JAX's capture suite (tests/accuracy/operators/test_attention_capture.py) on the card at its small shapes,
    through the port's CompiledStepPool: decode replay equal to eager for bf16 pages, int8 (C8) pages, SWA
    windows and MLA; two sessions of different batch stepped in turns through one pool; a permuted block table
    permuting a replay's rows; a top-k FusedDecode window replayed from one seeded generator."""
    from mojo_opset_tpu_torch.core.operators import MojoPagedDecodeGQA, MojoPagedDecodeSWA, MojoStorePagedKVCache
    from mojo_opset_tpu_torch.experimental.operators import (
        MojoPagedDecodeGQAWithKVDequant, MojoPagedDecodeMLA, MojoStorePagedKVCacheC8, MojoStorePagedMLAKVCache,
    )
    from mojo_opset_tpu_torch.runtime import CompiledStepPool

    gen = torch.Generator(device="cuda").manual_seed(17)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    batch, hq, hkv, d, bs, mb = 3, 8, 2, 128, 16, 6
    seq0 = torch.tensor([0, 19, 40], dtype=torch.int32, device="cuda")
    steps = 5

    def gqa_inputs(dtype=torch.bfloat16, scale=1.0):
        return [(randn(batch, hq, d, dtype=dtype, scale=scale), randn(batch, hkv, d, dtype=dtype, scale=scale),
                 randn(batch, hkv, d, dtype=dtype, scale=scale), seq0 + t) for t in range(steps)]

    store, attend = MojoStorePagedKVCache(), MojoPagedDecodeGQA()
    swa = MojoPagedDecodeSWA(local_window_size=24, global_window_size=4)
    for name, op in (("bf16 pages, kernel C", attend), ("SWA windows (local 24, global 4), kernel C", swa)):
        def step(state, q, kn, vn, lens, op=op):
            (kc, vc), table = state
            store(kn, vn, kc, vc, token_indices=_slots(torch, table, lens, bs))
            return op(q, kc, vc, lens + 1, table)

        _replay_matches_eager(torch, name, step, lambda: _paged_state(torch, batch, hkv, d, bs, mb, torch.bfloat16),
                              gqa_inputs())

    ks = torch.full((hkv, d), 0.02, device="cuda")
    vs = torch.full((hkv, d), 0.015, device="cuda")
    store8, attend8 = MojoStorePagedKVCacheC8(), MojoPagedDecodeGQAWithKVDequant()

    def step8(state, q, kn, vn, lens):
        (kc, vc), table = state
        store8(kn, vn, kc, vc, ks, vs, token_indices=_slots(torch, table, lens, bs))
        return attend8(q, None, kc, ks, vc, vs, lens + 1, table)

    _replay_matches_eager(torch, "int8 (C8) pages, kernel C'", step8,
                          lambda: _paged_state(torch, batch, hkv, d, bs, mb, torch.int8), gqa_inputs(scale=0.5))

    h, r, dr, dn, dv = 8, 128, 32, 64, 64
    store_mla = MojoStorePagedMLAKVCache()
    attend_mla = MojoPagedDecodeMLA(h, dn, dr, dv, r, device="cuda")

    def init_mla():
        table = torch.arange(batch * mb, dtype=torch.int32, device="cuda").reshape(batch, mb)
        return (torch.zeros((batch * mb + 1, 1, bs, r), dtype=torch.bfloat16, device="cuda"),
                torch.zeros((batch * mb + 1, 1, bs, dr), dtype=torch.bfloat16, device="cuda")), table

    def step_mla(state, q, cn, pn, lens):
        (cc, pc), table = state
        store_mla(cn, pn, cc, pc, token_indices=_slots(torch, table, lens, bs))
        return attend_mla(q, cc, pc, lens + 1, table)

    _replay_matches_eager(torch, "MLA latents, kernel I", step_mla, init_mla,
                          [(randn(batch, h, dn + dr), randn(batch, r), randn(batch, dr), seq0 + t)
                           for t in range(steps)])

    # two sessions of different batch through one pool, stepped in turns: no cross-talk, no recapture
    def step_gqa(state, q, kn, vn, lens):
        (kc, vc), table = state
        store(kn, vn, kc, vc, token_indices=_slots(torch, table, lens, bs))
        return attend(q, kc, vc, lens + 1, table)

    pool = CompiledStepPool(step_gqa, donate_argnums=(0,), name="interleaved sessions")
    sessions = {}
    for name, b, lens0 in (("a", 2, [0, 4]), ("b", 3, [1, 2, 30])):
        lens0 = torch.tensor(lens0, dtype=torch.int32, device="cuda")
        inputs = [(randn(b, hq, d), randn(b, hkv, d), randn(b, hkv, d), lens0 + t) for t in range(4)]
        eager = _paged_state(torch, b, hkv, d, bs, 5, torch.bfloat16)
        with torch.inference_mode():
            want = [step_gqa(eager, *x) for x in inputs]
        sessions[name] = dict(state=_paged_state(torch, b, hkv, d, bs, 5, torch.bfloat16), inputs=inputs, want=want)
    with torch.inference_mode():
        for t in range(4):
            for name in ("a", "b") if t % 2 == 0 else ("b", "a"):
                sess = sessions[name]
                got = pool.get_runner(sess["state"], *sess["inputs"][t])(sess["state"], *sess["inputs"][t])
                if not torch.equal(got, sess["want"][t]):
                    raise AssertionError(f"interleaved sessions: session {name} step {t} differs from its eager run")
    runners = pool.runners()
    if len(runners) != 2 or any(r.calls != 4 or r.graph is None for r in runners):
        raise AssertionError(f"interleaved sessions: {len(runners)} graphs, calls {[r.calls for r in runners]}")
    log("capture", "two sessions (bs 2 and 3) in turns through one pool: 2 graphs, each replayed, no cross-talk")

    # operands stay runtime inputs: a permuted block table permutes the replay's rows, other lengths change it
    kc, vc = randn(2 * 4 + 1, hkv, bs, d), randn(2 * 4 + 1, hkv, bs, d)
    t_a = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32, device="cuda")
    t_b = t_a.flip(0)
    q = randn(1, hq, d).expand(2, hq, d).contiguous()
    lens = torch.tensor([37, 37], dtype=torch.int32, device="cuda")
    pool = CompiledStepPool(lambda q, kc, vc, lens, table: attend(q, kc, vc, lens, table), donate_argnums=(),
                            name="operands")
    with torch.inference_mode():
        run = pool.get_runner(q, kc, vc, lens, t_a)
        run(q, kc, vc, lens, t_a)  # warm-up
        out_a = run(q, kc, vc, lens, t_a)
        out_b = run(q, kc, vc, lens, t_b)
        out_c = run(q, kc, vc, torch.tensor([9, 5], dtype=torch.int32, device="cuda"), t_a)
    if len(pool.runners()) != 1 or not (torch.equal(out_b[0], out_a[1]) and torch.equal(out_b[1], out_a[0])):
        raise AssertionError("a permuted block table did not permute the replayed rows")
    if (out_c.float() - out_a.float()).abs().max().item() <= 1e-4:
        raise AssertionError("other lengths did not change the replayed step")
    log("capture", "a permuted block table permutes the replay's rows; other lengths change it (one graph)")

    _topk_window(torch)


def _topk_window(torch) -> None:
    """A top-k FusedDecode window on a small bf16 Qwen3 replayed from a generator registered with its graph: from
    one state and one seed, the eager warm-up and two replays give the same tokens; a replay without reseeding
    draws other ones."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import FusedDecode, PagedAttentionGenerationModel

    model = Qwen3ForCausalLM(Qwen3Config(**SMALL, dtype=torch.bfloat16), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(3))
    ids, lens = _prompts(SMALL["vocab_size"], (37, 20, 5, 64))
    logits, session = PagedAttentionGenerationModel(model, block_size=16)(ids, context_input_len=lens)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    window = FusedDecode(model, sample_method="topk", top_k=50)
    gen = torch.Generator(device="cuda")
    runs = []
    for reseed in (True, True, True, False):
        if reseed:
            gen.manual_seed(11)
        runs.append(window(session, first, FUSED_STEPS, generator=gen).cpu().numpy())
        _rewind(session, FUSED_STEPS)
    runner = window._pool.runners()[0]
    if runner.graph is None or runner.calls != 4:
        raise AssertionError("the top-k window did not replay from one graph")
    warm, first_replay, second_replay, unseeded = runs
    if not np.array_equal(first_replay, second_replay):
        raise AssertionError("two replays from one seeded generator drew different tokens")
    if not np.array_equal(warm, first_replay):
        raise AssertionError("the eager warm-up and the replay drew different tokens from one seed")
    if np.array_equal(unseeded, second_replay):
        raise AssertionError("a replay without reseeding repeated the previous window's draws")
    log("capture", f"top-k window ({FUSED_STEPS} steps, bs 4, k 50): eager warm-up == two replays from seed 11; "
                   f"the next replay draws anew ({int((unseeded != second_replay).sum())} of {unseeded.size} tokens "
                   f"differ)")


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


# phase 18: the distributed layer (parallel/) on the card
TP_STEPS = 16  # greedy steps of phase 18's runs
TP_MOE_LAYERS = 6  # Qwen3-30B-A3B's depth cut 48 -> 6 for phase 18's MoE run
# the two-rank run against the unsharded model: bf16 row-parallel sums in another order (the probe that set it, a
# 4-layer tp 2 model, read per-row cosines 0.99998)
TP2_COSINE_BOUND = 0.999
TP2_TIE_GAP = 0.05  # a tp 2 stream may leave the unsharded stream only where the unsharded top-2 logits lie this close
TP2_TIMEOUT_S = 420
TP2_SPEC_K = 3  # draft tokens a round of the tp 2 speculative run (JAX tests/distributed/test_parallel_styles.py:259)
# the tp 2 C8 cache's channel scales against the unsharded model's rows of the rank's kv heads, the worst channel's
# relative gap: layer 0 reads the same int8 GEMM sums (bit for bit); deeper layers read a residual stream whose bf16
# row-parallel sums ran in another order (the probe that set it, on an H100 80GB HBM3 at 700 W, read 0.0485, layer 0
# exact)
C8_TP2_SCALE_REL_BOUND = 0.1


def _keep_logits():
    """A generator hook that keeps the logits of the prefill and of every decode step (``.steps``)."""
    from mojo_opset_tpu_torch.runtime import GeneratorHook

    class KeepLogits(GeneratorHook):
        def __init__(self):
            self.steps = []

        def after_prefill(self, *, logits, session):
            self.steps.append(logits)

        def after_decode_step(self, *, step, logits, next_token_id):
            self.steps.append(logits)

    return KeepLogits()


def _tp_stream(model, ids, lens, device_graph=None, fused=False, hook=None):
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel

    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE, device_graph=device_graph)
    gen = MojoGenerator(gm, None, GreedySampler(), max_new_tokens=TP_STEPS, hooks=[hook] if hook else None)
    return gen.generate_from_ids(ids, lens, ignore_eos=True, fused_decode=fused), gm


def _nccl_profile(torch, step) -> tuple:
    """(device busy ms, [(NCCL kernel, count, ms)]) of one profiled ``step()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = [(e.key, e.count, round(e.self_device_time_total / 1e3, 4)) for e in device if "nccl" in e.key.lower()]
    return sum(e.self_device_time_total for e in device) / 1e3, nccl


def _tp1_check(torch, tag, card, model, sharded, ids, lens, path_kernels) -> dict:
    """The sharded model on its one-rank NCCL group against the unsharded model (both from seed 0): prefill logits
    bit for bit; TP_STEPS greedy steps, stepwise and in a FusedDecode window, on graphs (each generator's second
    call replays) and eager, all one token stream, the graphed stepwise logits of each step bit for bit; every
    kernel of ``path_kernels`` launched by the sharded runs; a decode step of each timed in turns on its graph and
    profiled (the NCCL kernels). Returns the sharded runs' launch counts."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    logits = [PagedAttentionGenerationModel(m, block_size=BLOCK_SIZE)(ids, context_input_len=lens)[0]
              for m in (model, sharded)]
    if not torch.equal(*logits):
        raise AssertionError(f"{tag}: prefill logits differ from the unsharded model's by "
                             f"{(logits[0] - logits[1]).abs().max().item()}")
    streams, kept = {}, []
    for name, m in (("unsharded", model), ("sharded", sharded)):
        if name == "sharded":
            kernels.reset_launch_counts()
        hook = _keep_logits()
        graphed, gm = _tp_stream(m, ids, lens)
        streams[f"{name} graphed"] = graphed
        streams[f"{name} graphed again"] = _tp_stream(m, ids, lens, hook=hook)[0]  # a new pool: warm-up, capture, replay
        if not any(r.graph is not None for r in gm.runners()):
            raise AssertionError(f"{tag}: {name} decode steps never replayed from a graph")
        kept.append(hook.steps)
        for fused in (False, True):
            streams[f"{name} eager{' fused' if fused else ''}"] = _tp_stream(m, ids, lens, False, fused)[0]
        streams[f"{name} graphed fused"] = _tp_stream(m, ids, lens, None, True)[0]
        if name == "sharded":
            counts = {k: v for k, v in kernels.launch_counts().items() if k in path_kernels}
    want = streams["unsharded graphed"]
    for what, got in streams.items():
        if not np.array_equal(got, want):
            raise AssertionError(f"{tag}: {what} tokens {got.tolist()} differ from {want.tolist()}")
    unequal = [i for i, (a, b) in enumerate(zip(*kept)) if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"{tag}: graphed step logits differ from the unsharded model's at steps {unequal}")
    if min(counts.get(k, 0) for k in path_kernels) <= 0:
        raise AssertionError(f"{tag}: a kernel of the path never launched in the sharded runs: {counts}")
    log(tag, f"prefill logits bit for bit; {TP_STEPS} greedy steps (stepwise and FusedDecode, graphs and eager) "
             f"one stream == unsharded, graphed step logits bit for bit; launches {counts}")

    def graph_step(m):
        gm = PagedAttentionGenerationModel(m, block_size=BLOCK_SIZE)
        out, session = gm(ids, context_input_len=lens)
        token = torch.argmax(out, dim=-1).to(torch.int32)
        for _ in range(2):  # warm-up, capture
            gm(token, session=session)
            _rewind(session)
        eager = PagedAttentionGenerationModel(m, block_size=BLOCK_SIZE, device_graph=False)

        def step(g=gm):
            g(token, session=session)
            _rewind(session)
        return step, lambda: step(eager)

    steps = {name: graph_step(m) for name, m in (("unsharded", model), ("sharded", sharded))}
    times = {name: [] for name in steps}
    for _ in range(GRAPH_TURNS):
        for name, (step, _) in steps.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t) * 1e3)
    busy, nccl = _nccl_profile(torch, steps["sharded"][0])
    plain_busy, _ = _nccl_profile(torch, steps["unsharded"][0])
    eager_busy, eager_nccl = _nccl_profile(torch, steps["sharded"][1])
    medians = {k: float(np.median(v)) for k, v in times.items()}
    log(tag, f"{card}: decode step on its graph (bs {len(lens)}, context ~1050), {GRAPH_TURNS} turns each: sharded "
             f"{times['sharded']} ms, unsharded {times['unsharded']} ms; medians {medians['sharded']:.3f} vs "
             f"{medians['unsharded']:.3f} ms; device busy {busy:.3f} vs {plain_busy:.3f} ms; NCCL kernels of the "
             f"graph step {nccl} (of the eager step {eager_nccl}, busy {eager_busy:.3f} ms); a one-rank all_reduce "
             f"in place launches nothing")
    return counts


def _tp_reference(torch, model, ids, lens) -> dict:
    """The unsharded model's eager stream, its logits of every step kept (on the host), for the tp 2 run; and the
    same of its w8a8 + C8 twin (``quantize_qwen3(quant_kv=True)``) with the channel scales its prefill calibrated
    (layers x (key, value) x (8 kv heads, 128))."""
    from mojo_opset_tpu_torch.modeling.qwen3 import quantize_qwen3
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel

    hook = _keep_logits()
    tokens, gm = _tp_stream(model, ids, lens, device_graph=False, hook=hook)
    c8 = quantize_qwen3(model, quant_kv=True)
    gm = PagedAttentionGenerationModel(c8, block_size=BLOCK_SIZE, device_graph=False)
    _, session = gm(ids, context_input_len=lens)
    scales = _c8_scales(session)
    c8_hook = _keep_logits()
    c8_tokens, _ = _tp_stream(c8, ids, lens, device_graph=False, hook=c8_hook)
    del c8, session
    gc.collect()
    torch.cuda.empty_cache()
    return dict(tokens=tokens, steps=[s.float().cpu() for s in hook.steps],
                c8=dict(tokens=c8_tokens, steps=[s.float().cpu() for s in c8_hook.steps], scales=scales))


def _c8_scales(session) -> np.ndarray:
    """A C8 session's channel scales, (layers, 2, kv heads, head_dim): key then value."""
    caches = session.caches
    return np.stack([np.stack([caches.key_scale(i).cpu().numpy(), caches.value_scale(i).cpu().numpy()])
                     for i in range(len(caches.key_scales))])


def _tie_note(tag: str, tokens, ref_tokens, ref_steps) -> str:
    """``tokens`` against the unsharded stream ``ref_tokens`` (its logits of every step ``ref_steps``): equal, or
    parting first where the unsharded top-2 logits lie within TP2_TIE_GAP (a near-tie); else raises."""
    if np.array_equal(tokens, ref_tokens):
        return "== the unsharded stream"
    parted = np.argwhere(tokens != ref_tokens)
    row, step = (int(i) for i in parted[np.argmin(parted[:, 1])])
    top2 = np.sort(ref_steps[step][row].numpy())[-2:]
    gap = float(top2[1] - top2[0])
    note = (f"parts from the unsharded stream at step {step} of row {row}, where the unsharded top-2 gap is "
            f"{gap:.4g} (a near-tie, bound {TP2_TIE_GAP})")
    if gap >= TP2_TIE_GAP:
        raise AssertionError(f"{tag}: tokens {tokens.tolist()} differ from {ref_tokens.tolist()}: {note}")
    return note


def _tp2_worker(rank: int, workdir: str) -> None:
    """One of phase 18's two ranks on the one card (gloo carries CUDA tensors; NCCL refuses two ranks on one
    device): Qwen3-4B at full width and tp 2, eager; writes its prefill logits, tokens and step times. Then (phase
    23's part of this spawn) greedy speculative decoding of that target with its w8a8 draft (``quantize_qwen3``,
    then sharded, as JAX does), and the w8a8 + C8 twin's stream and channel scales, each run counted."""
    import torch

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
    from mojo_opset_tpu_torch.parallel import build_mesh, init_distributed, qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel, SpeculativeDecoder

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rank, 2, f"file://{workdir}/rendezvous", device="cuda", backend="gloo")
    mesh = build_mesh((2,), ("tp",))
    config = Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16, kv_layout="NHD")
    model = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    draft, c8 = quantize_qwen3(model), quantize_qwen3(model, quant_kv=True)  # quantized whole, then sharded
    model, draft, c8 = (shard_model(m, mesh, qwen3_tp_rules("tp")) for m in (model, draft, c8))
    torch.cuda.empty_cache()
    try:
        PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
        refused = None
    except ValueError as err:
        refused = str(err)
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE, device_graph=False)
    logits, session = gm(ids, context_input_len=lens)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    ms = []
    for _ in range(GRAPH_TURNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        gm(token, session=session)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        _rewind(session)
    tokens = _tp_stream(model, ids, lens, device_graph=False)[0]
    try:
        SpeculativeDecoder(model, draft, k=TP2_SPEC_K, block_size=BLOCK_SIZE)  # graphs by default on the card
        spec_refused = None
    except ValueError as err:
        spec_refused = str(err)
    spec = SpeculativeDecoder(model, draft, k=TP2_SPEC_K, mode="greedy", block_size=BLOCK_SIZE, device_graph=False)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    spec_tokens = spec.generate(ids, lens, max_new_tokens=TP_STEPS)
    spec_s = time.perf_counter() - t0
    spec_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    _, session = PagedAttentionGenerationModel(c8, block_size=BLOCK_SIZE, device_graph=False)(ids,
                                                                                             context_input_len=lens)
    c8_tokens = _tp_stream(c8, ids, lens, device_graph=False)[0]
    c8_counts = kernels.launch_counts()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), logits=logits.float().cpu().numpy(), tokens=tokens,
             step_ms=np.asarray(ms), refused=np.asarray(refused or ""),
             weights_gib=np.asarray(sum(p.numel() * p.element_size() for p in model.parameters()) / 2**30),
             spec_tokens=spec_tokens, spec_rounds=np.asarray(spec.last_rounds), spec_s=np.asarray(spec_s),
             spec_refused=np.asarray(spec_refused or ""), spec_counts=json.dumps(spec_counts),
             c8_tokens=c8_tokens, c8_scales=_c8_scales(session), c8_kv_heads=np.asarray(session.num_kv_heads),
             c8_counts=json.dumps(c8_counts), peak_gib=np.asarray(torch.cuda.max_memory_allocated() / 2**30))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _tp2_run(torch, card, reference) -> dict:
    """Qwen3-4B at tp 2 in two processes on the one card (gloo), eager, against the unsharded ``reference``: each
    rank's greedy tokens equal, or part from the unsharded stream only at a near-tie (TP2_TIE_GAP), and its
    prefill logits' per-row cosine >= TP2_COSINE_BOUND. Phase 23's part: the speculative stream (a w8a8 draft,
    graphs refused over gloo) and the w8a8 + C8 twin's stream under the same rule, each rank's C8 scales against
    the unsharded twin's rows of its kv heads (C8_TP2_SCALE_REL_BOUND). Returns rank 0's launches of those two
    runs."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="tp2_")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke as s; s._tp2_worker({r}, {workdir!r})"],
                              cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=TP2_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise AssertionError(f"tp 2: rank processes failed: {failed}")
    ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(2)]
    shutil.rmtree(workdir, ignore_errors=True)
    if not np.array_equal(ranks[0]["tokens"], ranks[1]["tokens"]) or not np.array_equal(ranks[0]["logits"],
                                                                                         ranks[1]["logits"]):
        raise AssertionError("tp 2: the two ranks hold other tokens or logits")
    if not all(str(r["refused"]) and "gloo" in str(r["refused"]) for r in ranks):
        raise AssertionError(f"tp 2: graphs over gloo were not refused: {[str(r['refused']) for r in ranks]}")
    want = reference["steps"][0].numpy()
    got = ranks[0]["logits"]
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    if cos.min() < TP2_COSINE_BOUND:
        raise AssertionError(f"tp 2: prefill logits part from the unsharded model's: cosine {cos.tolist()}")
    note = _tie_note("tp 2", ranks[0]["tokens"], reference["tokens"], reference["steps"])
    log("parallel tp 2", f"{card}: Qwen3-4B at full width, tp 2 in two processes on the one card over gloo "
                         f"(NCCL refuses two ranks on one device), eager (graphs refused over gloo); both ranks one "
                         f"stream, {TP_STEPS} greedy steps {note}; prefill logits per-row cosine vs unsharded "
                         f"{[round(float(c), 6) for c in cos]} (bound {TP2_COSINE_BOUND}); eager decode step ms "
                         f"{ranks[0]['step_ms'].round(3).tolist()} (rank 0); a rank's weights "
                         f"{float(ranks[0]['weights_gib']):.2f} GiB, peak {float(ranks[0]['peak_gib']):.1f} GiB; "
                         f"{time.perf_counter() - t0:.1f} s with the processes' start")
    return _tp2_spec_c8(card, ranks, reference)


def _tp2_spec_c8(card, ranks, reference) -> dict:
    """Phase 23's checks of the tp 2 ranks' speculative and C8 runs (``_tp2_run``)."""
    if not all("gloo" in str(r["spec_refused"]) for r in ranks):
        raise AssertionError(f"tp 2: speculative graphs over gloo were not refused: "
                             f"{[str(r['spec_refused']) for r in ranks]}")
    for what, key in (("speculative", "spec_tokens"), ("C8", "c8_tokens")):
        if not np.array_equal(ranks[0][key], ranks[1][key]):
            raise AssertionError(f"tp 2 {what}: the two ranks hold other tokens")
    spec_note = _tie_note("tp 2 speculative", ranks[0]["spec_tokens"], reference["tokens"], reference["steps"])
    c8_ref = reference["c8"]
    c8_note = _tie_note("tp 2 C8", ranks[0]["c8_tokens"], c8_ref["tokens"], c8_ref["steps"])
    worst, layer0 = 0.0, True
    for rank, r in enumerate(ranks):
        kv = int(r["c8_kv_heads"])
        want = c8_ref["scales"][:, :, rank * kv:(rank + 1) * kv]
        got = r["c8_scales"]
        if got.shape != want.shape:
            raise AssertionError(f"tp 2 C8: rank {rank} scales {got.shape}, want {want.shape}")
        worst = max(worst, float(np.max(np.abs(got - want) / np.abs(want))))
        layer0 = layer0 and np.array_equal(got[0], want[0])
    counts = [{k: v for k, v in json.loads(str(ranks[0][key])).items() if v} for key in ("spec_counts", "c8_counts")]
    log("parallel tp 2", f"{card}: greedy speculative decoding (w8a8 draft quantized whole then sharded, bf16 target, "
                         f"k {TP2_SPEC_K}, eager: graphs refused over gloo) {TP_STEPS} tokens x {len(PROMPT_LENS)} in "
                         f"{int(ranks[0]['spec_rounds'])} rounds, {float(ranks[0]['spec_s']):.2f} s: {spec_note}; "
                         f"launches (rank 0) {counts[0]}")
    log("parallel tp 2", f"{card}: w8a8 + C8 twin at tp 2 ({int(ranks[0]['c8_kv_heads'])} kv heads a rank): "
                         f"{TP_STEPS} greedy steps {c8_note}; each rank's channel scales against the unsharded twin's "
                         f"rows of its kv heads: worst relative gap {worst:.3g} (bound {C8_TP2_SCALE_REL_BOUND}), "
                         f"layer 0 bit for bit: {layer0}; launches (rank 0) {counts[1]}")
    if worst > C8_TP2_SCALE_REL_BOUND:
        raise AssertionError(f"tp 2 C8: channel scales part from the unsharded twin's by {worst}")
    return {"parallel_tp2_speculative": counts[0], "parallel_tp2_c8": counts[1]}


def phase_parallel(torch, card: str) -> dict:
    """Phase 18: the distributed layer (``mojo_opset_tpu_torch.parallel``) on the card. (a) a one-rank NCCL group
    through the port's init: Qwen3-4B at full width in bf16 through ``qwen3_tp_rules`` at tp 1, then Qwen3-30B-A3B
    at full width cut to TP_MOE_LAYERS layers through ``qwen3_tp_rules + moe_ep_rules`` at tp 1 x ep 1, each
    against its unsharded twin (``_tp1_check``); (b) Qwen3-4B at tp 2 in two processes on the one card
    (``_tp2_run``). Returns the sharded runs' launch counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mojo_opset_tpu_torch.modeling.qwen3 import (
        Qwen3Config,
        Qwen3ForCausalLM,
        Qwen3MoeConfig,
        Qwen3MoeForCausalLM,
    )
    from mojo_opset_tpu_torch.parallel import build_mesh, init_distributed, moe_ep_rules, qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime.comm_context import model_groups

    rendezvous = tempfile.mkdtemp(prefix="tp1_")
    t0 = time.perf_counter()
    init_distributed(0, 1, f"file://{rendezvous}/rendezvous", device="cuda")
    mesh = build_mesh((1, 1), ("tp", "ep"))
    log("parallel", f"one-rank NCCL world (NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}) and its (tp, ep) "
                    f"groups in {time.perf_counter() - t0:.2f} s")

    def pair(config, model_cls, rules):
        def draw():
            return model_cls(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        model = draw()
        sharded = shard_model(draw(), mesh, rules)
        if {dist.get_backend(g) for g in model_groups(sharded)} != {"nccl"}:
            raise AssertionError("the sharded model does not communicate over the NCCL groups")
        return model, sharded

    counts = {}
    config = Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16, kv_layout="NHD")
    ids, lens = _prompts(config.vocab_size, PROMPT_LENS)
    model, sharded = pair(config, Qwen3ForCausalLM, qwen3_tp_rules("tp"))
    counts["parallel_tp1"] = _tp1_check(torch, "parallel tp 1", card, model, sharded, ids, lens, BF16_PATH_KERNELS)
    reference = _tp_reference(torch, model, ids, lens)
    del model, sharded
    gc.collect()
    torch.cuda.empty_cache()
    moe_config = Qwen3MoeConfig(**dict(QWEN3_30B_A3B, num_hidden_layers=TP_MOE_LAYERS), dtype=torch.bfloat16)
    model, sharded = pair(moe_config, Qwen3MoeForCausalLM, qwen3_tp_rules("tp") + moe_ep_rules("ep"))
    if sharded.layers[0].mlp.ep_group is None:
        raise AssertionError("the MoE blocks were not made expert-parallel")
    counts["parallel_moe_tp1_ep1"] = _tp1_check(torch, "parallel moe tp 1 x ep 1", card, model, sharded, ids, lens,
                                                MOE_PATH_KERNELS)
    del model, sharded
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    shutil.rmtree(rendezvous, ignore_errors=True)
    counts.update(_tp2_run(torch, card, reference))
    return counts


# phase 19: the runtime tooling through the example entry points (mojo_opset_tpu_torch.examples)
TOOLING_WIDTH = []  # llm_inference's own default width, JAX's Qwen3Config(): hidden 4096, 32 layers, vocab 151936
TOOLING_LAYERS = 32  # that model's depth, which the expected compare records follow
TOOLING_STEPS = 16  # --max-new-tokens of its runs
TOOLING_COMPARE = "0:*,31:*"  # every op at its first and 32nd call a forward
TOOLING_DUMP = "0:RMSNorm"
# each compare record (the cuda tier against the golden on the same inputs) holds 1 - cos_sim <= TOOLING_COSINE_GAP
# (readings on an H100: at most 4e-6) and max_abs <= TOOLING_ULPS roundings at the golden output's largest
# element: of bf16 for a float output (the path's working type), one step for an integer one (E's int8 codes)
TOOLING_COSINE_GAP = 1e-4
TOOLING_ULPS = 2
TOOLING_NORM_SPREAD = 0.25  # the runs' RMSNorm weights: 1 + this x N(0, 1), seeded (they start at ones)
TOOLING_INT8_STEPS = 4  # --max-new-tokens of the w8a8 + C8 run at the default width, under the debugger
# kernels A-D in the profiler's chrome trace, by the names of their CUDA kernels
TOOLING_FAMILIES = {"A": A_KERNEL_NAMES, "B": ("rope_token_first",), "C": ("paged_decode_kernel",),
                    "D": ("paged_prefill_",)}
ALLOC_BATCHES = (8, 24)  # the host reading: a session at these batches, each sequence at ALLOC_CTX tokens
ALLOC_CTX = 4000
ALLOC_STEPS = 200  # reserves (and decode-step metadata) timed a turn
ALLOC_TURNS = 5
ALLOC_GRAPH_STEPS = 10  # graph steps of the bf16 Qwen3-4B a turn with each allocator, each taken back after it


def _expected_compare_records(layers: int, rule_layers=(0, 31)) -> dict:
    """The compare records one forward of the dense Qwen3 yields under rules on occurrences ``rule_layers`` of every
    op, by op name. Its cuda-tier ops in call order: RMSNorm (input, q, k, post-attention: 4 a layer, then the final
    norm), ApplyRoPE (one a layer, two outputs: q and k) and the paged attention (one a layer, PagedPrefillGQA in a
    prefill, PagedDecodeGQA in a decode step); the embedding, GEMMs, store and SiLU have only the golden tier. A rule
    on occurrence n matches an op called more than n times a forward."""
    calls = {"RMSNorm": (4 * layers + 1, 1), "ApplyRoPE": (layers, 2), "attention": (layers, 1)}
    return {op: outs * sum(n < count for n in rule_layers) for op, (count, outs) in calls.items()}


def _record_limit(record: dict) -> float:
    """The largest max_abs a compare record may read (see TOOLING_ULPS)."""
    if record["dtype"].startswith(("int", "uint")):
        return 1.0
    if record["ref_max"] <= 0:
        return 0.0
    return TOOLING_ULPS * 2.0 ** (math.floor(math.log2(record["ref_max"])) - 7)


def _check_records(what: str, records: list) -> None:
    """Hold each compare record to TOOLING_COSINE_GAP and _record_limit."""
    bad = [r for r in records if not (1 - r["cos_sim"] <= TOOLING_COSINE_GAP and r["max_abs"] <= _record_limit(r))]
    if not records or bad:
        raise AssertionError(f"tooling: {what}: {len(bad)} of {len(records)} compare records past their limits: "
                             f"{bad[:8]}")


def _worst_by_op(records: list) -> dict:
    """By op: the largest max_abs, and the largest share of its limit any record reads."""
    worst = {}
    for r in records:
        limit = _record_limit(r)
        share = r["max_abs"] / limit if limit else float(r["max_abs"] > 0) * math.inf
        got = worst.get(r["op"], (0.0, 0.0))
        worst[r["op"]] = (max(got[0], r["max_abs"]), max(got[1], share))
    return {op: f"{a} ({share:.2f} of its limit)" for op, (a, share) in worst.items()}


def _random_norms(torch, build):
    """``build`` (an example's model-building function) with every RMSNorm weight drawn as 1 + TOOLING_NORM_SPREAD x N(0, 1)
    from seed 1 on the model's device, so a compare sees a kernel that drops or misapplies the weight."""
    from mojo_opset_tpu_torch.core.operators.normalization import MojoRMSNorm, MojoRMSNormQuant

    def built(args):
        model = build(args)
        gen = torch.Generator(device=args.device).manual_seed(1)
        for mod in model.modules():
            if isinstance(mod, (MojoRMSNorm, MojoRMSNormQuant)):
                w = mod.weight
                w.add_(TOOLING_NORM_SPREAD * torch.randn(w.shape, generator=gen, device=w.device).to(w.dtype))
        return model

    return built


def _trace_kernels(path: str) -> set:
    """The CUDA kernel names in a torch.profiler chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def _tooling_llm(torch, card: str) -> dict:
    """``llm_inference --greedy`` at its default width on the card (see phase_tooling), its RMSNorm weights drawn
    at random (``_random_norms``); returns the counted runs' launches by path: bf16 on graphs, and w8a8 + C8
    eager under the debugger."""
    from mojo_opset_tpu_torch.examples import llm_inference

    build = llm_inference.build_model
    llm_inference.build_model = _random_norms(torch, build)
    try:
        return _tooling_llm_runs(torch, card)
    finally:
        llm_inference.build_model = build


def _tooling_llm_runs(torch, card: str) -> dict:
    """The runs of ``_tooling_llm``."""
    import logging
    import shutil
    import tempfile

    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.examples import llm_inference
    from mojo_opset_tpu_torch.utils import logging as mojo_logging
    from mojo_opset_tpu_torch.utils.debugger import MojoDebugger

    base = [*TOOLING_WIDTH, "--greedy", "--max-new-tokens", str(TOOLING_STEPS)]

    def run(*flags, steps=TOOLING_STEPS):
        t0 = time.perf_counter()
        result = llm_inference.main([*base, *flags, "--max-new-tokens", str(steps)])
        gc.collect()
        torch.cuda.empty_cache()
        if result["allocator"] != "native":
            raise AssertionError(f"tooling: the session's allocator is {result['allocator']}, not native")
        if result["ids"].shape != (1, steps) or not ((result["ids"] >= 0) & (result["ids"] < 151936)).all():
            raise AssertionError(f"tooling: llm_inference {flags} gave ids {result['ids']}")
        log("tooling", f"llm_inference {' '.join(flags) or '(graphs)'}: {time.perf_counter() - t0:.1f} s with the "
                       f"model's build, generate {result['seconds']:.2f} s; ids {result['ids'][0].tolist()}")
        return result

    # (a) on graphs, counted: the path launches A-D
    kernels.reset_launch_counts()
    plain = run()
    counts = {k: v for k, v in kernels.launch_counts().items() if k in BF16_PATH_KERNELS}
    log("tooling", f"launches of llm_inference's run (prefill, {TOOLING_STEPS - 1} decode steps on graphs): {counts}")
    if not all(counts.get(k) for k in BF16_PATH_KERNELS):
        raise AssertionError(f"tooling: a kernel of the path did not launch: {counts}")

    # (b) eager, under the debugger: one compare record per output of every op the rules name, each against its
    # golden twin on the same CUDA tensors, and one dump a forward
    dump_dir = tempfile.mkdtemp(prefix="mojo_debug_")
    MojoDebugger.dump_dir = dump_dir
    debug = run("--debug-compare", TOOLING_COMPARE, "--debug-dump", TOOLING_DUMP)
    forwards = debug["ids"].shape[1]  # the prefill and one decode step a later token
    want = _expected_compare_records(TOOLING_LAYERS)
    records = debug["debug"]["records"]
    by_op = {}
    for r in records:
        op = "attention" if r["op"] in ("PagedPrefillGQA", "PagedDecodeGQA") else r["op"]
        by_op[op] = by_op.get(op, 0) + 1
    dumps = sorted(os.listdir(os.path.join(dump_dir, "rank0")))
    shutil.rmtree(dump_dir, ignore_errors=True)
    same = "equal" if np.array_equal(debug["ids"], plain["ids"]) else "differ from"
    log("tooling", f"{card}: debugger '{TOOLING_COMPARE}' over {forwards} forwards: {len(records)} compare records "
                   f"(expected {forwards} x {want}), counts {debug['debug']['counts']}; least cos_sim "
                   f"{min(r['cos_sim'] for r in records):.7f}; worst max_abs by op "
                   f"{_worst_by_op(records)}; {len(dumps)} dumps "
                   f"('{TOOLING_DUMP}'); the eager tokens {same} the graph run's")
    if by_op != {op: n * forwards for op, n in want.items()} or debug["debug"]["counts"] != {
            "compare": len(records), "dump": forwards, "errors": 0} or len(dumps) != forwards:
        raise AssertionError(f"tooling: compare records by op {by_op}, expected {forwards} x {want}; counts "
                             f"{debug['debug']['counts']}; {len(dumps)} dump files")
    _check_records("bf16 default width", records)

    # (c) on graphs with the debugger enabled through its API: captures warn and replay as they would; the
    # prefill and the first decode step (the graph's eager warm-up) compare
    class Messages(logging.Handler):
        def __init__(self):
            super().__init__()
            self.seen = []

        def emit(self, record):
            self.seen.append(record.getMessage())

    handler = Messages()
    debug_logger = logging.getLogger("mojo_opset_tpu_torch.utils.debugger")
    debug_logger.addHandler(handler)
    mojo_logging._WARNED.clear()
    MojoDebugger.enable(compare=TOOLING_COMPARE)
    try:
        graphed = run()
    finally:
        MojoDebugger.disable()
        debug_logger.removeHandler(handler)
    capture_warnings = sum("CUDA graph capture" in m for m in handler.seen)
    log("tooling", f"graphs with the debugger on: {len(MojoDebugger.records)} compare records (the prefill and the "
                   f"warm-up step), {capture_warnings} capture warning; tokens "
                   f"{'equal' if np.array_equal(graphed['ids'], plain['ids']) else 'DIFFER from'} the run without it")
    warm = 2 * sum(want.values())  # the prefill's records and the warm-up step's
    if (not np.array_equal(graphed["ids"], plain["ids"]) or capture_warnings != 1
            or len(MojoDebugger.records) != warm or MojoDebugger.counts["errors"]):
        raise AssertionError(f"tooling: graphs under the debugger: tokens {graphed['ids']} vs {plain['ids']}, "
                             f"{capture_warnings} capture warnings, {len(MojoDebugger.records)} records, counts "
                             f"{MojoDebugger.counts}")

    # (d) the profiler hook over the whole run (prefill on, wait=0) and the chrome-trace spans, in one run
    out_dir = tempfile.mkdtemp(prefix="mojo_tools_")
    spans_path = os.path.join(out_dir, "spans.json")
    traced = run("--profile-dir", os.path.join(out_dir, "profile"), "--trace-out", spans_path)
    names = _trace_kernels(traced["profile"][0])
    found = {f: sorted({n for n in names if any(p in n for p in pats)})[:3] for f, pats in TOOLING_FAMILIES.items()}
    with open(spans_path) as f:
        spans = [(e["name"], e["ph"]) for e in json.load(f)["traceEvents"]]
    with open(traced["profile"][0]) as f:  # the runtime's spans beside the kernels, on the profiler's clock
        replays = sum(e.get("name") == "mojo.graph.replay" for e in json.load(f)["traceEvents"])
    size_mb = os.path.getsize(traced["profile"][0]) / 1e6
    shutil.rmtree(out_dir, ignore_errors=True)
    steps = traced["ids"].shape[1] - 1  # decode steps: the first warms the graph up, each later one replays it
    log("tooling", f"profiler trace ({size_mb:.1f} MB, {len(names)} kernel names): {found}, {replays} "
                   f"mojo.graph.replay over {steps} decode steps; chrome-trace spans: "
                   f"{spans.count(('llm_inference', 'E'))} run, {spans.count(('mojo.generate', 'E'))} mojo.generate, "
                   f"{spans.count(('mojo.prefill', 'E'))} mojo.prefill, "
                   f"{spans.count(('mojo.decode_step', 'E'))} mojo.decode_step")
    if not all(found.values()):
        raise AssertionError(f"tooling: kernels missing from the profiler's trace: {found}")
    if (spans.count(("llm_inference", "E")), spans.count(("mojo.generate", "E")), spans.count(("mojo.prefill", "E")),
            spans.count(("mojo.decode_step", "E"))) != (1, 1, 1, steps):
        raise AssertionError(f"tooling: the chrome trace's spans: {spans}")
    if replays != steps - 1:
        raise AssertionError(f"tooling: {replays} mojo.graph.replay in the profiler's trace, not one a graphed "
                             f"step ({steps - 1})")

    # (e) --quant w8a8 --quant-kv at the same width, eager under the debugger: E, F and C's int8 pages at their
    # real shapes, each compared with its golden on the same inputs
    kernels.reset_launch_counts()
    int8 = run("--quant", "w8a8", "--quant-kv", "--debug-compare", TOOLING_COMPARE, steps=TOOLING_INT8_STEPS)
    int8_counts = {k: v for k, v in kernels.launch_counts().items() if k in INT8_PATH_KERNELS}
    records = int8["debug"]["records"]
    log("tooling", f"{card}: w8a8 + C8, debugger '{TOOLING_COMPARE}' over {TOOLING_INT8_STEPS} forwards: "
                   f"{len(records)} compare records, counts {int8['debug']['counts']}; least cos_sim "
                   f"{min(r['cos_sim'] for r in records):.7f}; worst max_abs by op {_worst_by_op(records)}; "
                   f"launches {int8_counts}")
    if not all(int8_counts.get(k) for k in INT8_PATH_KERNELS) or int8["debug"]["counts"]["errors"]:
        raise AssertionError(f"tooling: w8a8 + C8: launches {int8_counts}, counts {int8['debug']['counts']}")
    if not {"RMSNormQuant", "QuantGemm", "PagedDecodeGQAWithKVDequant"} <= {r["op"] for r in records}:
        raise AssertionError(f"tooling: w8a8 + C8: ops compared {sorted({r['op'] for r in records})}")
    _check_records("w8a8 + C8 default width", records)
    return {"tooling": counts, "tooling_w8a8": int8_counts}


def _tooling_tiny(torch, card: str) -> None:
    """The tiny examples on the card: llm_inference's int8 modes (shape and range) and greedy speculative decoding
    held to the plain greedy run of the same model (lossless: a stream may leave it only at a bf16 tie,
    ``_first_divergence``), continuous_serving held to the same batcher with device_graph=False, and
    dit_inference at its defaults (shape, finiteness)."""
    from mojo_opset_tpu_torch.examples import continuous_serving, dit_inference, llm_inference
    from mojo_opset_tpu_torch.runtime import ContinuousBatchingGenerator, PagedAttentionGenerationModel

    tiny = ["--tiny", "--greedy"]
    results = {}
    for name, flags in (("greedy", []), ("w8a8 + C8", ["--quant", "w8a8", "--quant-kv"]),
                        ("speculative", ["--speculative", "4"])):
        result = llm_inference.main([*tiny, *flags])
        if result["ids"].shape != (1, 32) or not ((result["ids"] >= 0) & (result["ids"] < 32000)).all():
            raise AssertionError(f"tooling: llm_inference --tiny {flags}: {result['ids']}")
        results[name] = result
        log("tooling", f"llm_inference --tiny {' '.join(flags) or '--greedy'}: 32 ids in {result['seconds']:.2f} s"
                       + (f", {result['rounds']} verify rounds" if "rounds" in result else ""))
    args = llm_inference._parser().parse_args(tiny)
    model = llm_inference.build_model(args)
    gm = PagedAttentionGenerationModel(model, block_size=args.block_size)
    prompt = np.asarray(llm_inference._FallbackTokenizer()(args.prompt).input_ids[0], np.int32)
    log("tooling", f"{card}: llm_inference --tiny --speculative 4 against --greedy: "
                   + _first_divergence(torch, gm, prompt, results["greedy"]["ids"][0],
                                       results["speculative"]["ids"][0]))

    serving = continuous_serving.main([])
    if sorted(len(v) for v in serving["requests"].values()) != [16] * 8:
        raise AssertionError(f"tooling: continuous_serving: {serving['requests']}")
    eager = ContinuousBatchingGenerator(model, batch_slots=4, block_size=32, max_new_tokens=16, device_graph=False)
    rng = np.random.default_rng(0)  # continuous_serving's request stream
    rids = [eager.submit(rng.integers(1, 32000, (int(n),)).astype(np.int32)) for n in rng.integers(4, 48, (8,))]
    want = eager.run()
    differ = [rid for rid in rids if not np.array_equal(serving["requests"][rid], np.asarray(want[rid]))]
    log("tooling", f"continuous_serving: 8 requests, {serving['tokens']} tokens in {serving['seconds']:.2f} s "
                   f"({serving['tokens_per_s']:.1f} tok/s aggregate, graphs); {8 - len(differ)} of 8 requests "
                   f"equal to the batcher's with device_graph=False")
    if differ or sorted(serving["requests"]) != sorted(rids):
        raise AssertionError(f"tooling: continuous_serving on graphs against device_graph=False: requests {differ} "
                             f"differ: {[(serving['requests'][r].tolist(), list(want[r])) for r in differ[:2]]}")
    del model, gm, eager
    dit = dit_inference.main([])
    if dit["latent"].shape != (16, 2, 8, 8) or not torch.isfinite(dit["latent"]).all():
        raise AssertionError(f"tooling: dit_inference: latent {tuple(dit['latent'].shape)}")
    log("tooling", f"dit_inference: 10 steps in {dit['elapsed_seconds'][-1]:.2f} s, latent mean {dit['mean']:.4f} "
                   f"std {dit['std']:.4f}")
    gc.collect()
    torch.cuda.empty_cache()


def _allocator_host_us(torch, card: str) -> None:
    """A reading, not a claim: the host µs of a decode step's reserve and of its whole host metadata
    (``decode_arrays``: the reserve, positions, lengths, the table's copy, the store's slots), the native allocator
    against numpy, at ALLOC_BATCHES with every sequence at ALLOC_CTX tokens, ALLOC_STEPS a turn, in turns; a
    one-layer session (the host work does not depend on depth). Both end on the same tables."""
    from mojo_opset_tpu_torch.runtime.config import MojoConfig, MojoModelConfig
    from mojo_opset_tpu_torch.runtime.session import PagedAttentionRuntimeState

    mc = MojoModelConfig(model_name="qwen3", hidden_size=QWEN3_4B["hidden_size"], head_dim=QWEN3_4B["head_dim"],
                         num_heads=QWEN3_4B["num_attention_heads"], num_kv_heads=QWEN3_4B["num_key_value_heads"],
                         num_layers=1, vocab_size=QWEN3_4B["vocab_size"],
                         max_position_embeddings=QWEN3_4B["max_position_embeddings"], dtype=torch.bfloat16)
    for batch in ALLOC_BATCHES:
        sessions = {}
        for mode in ("1", "0"):
            os.environ["MOJO_NATIVE"] = mode
            session = PagedAttentionRuntimeState(MojoConfig(model_config=mc), batch, block_size=BLOCK_SIZE,
                                                 device="cuda")
            sessions[session.allocator] = session
        os.environ["MOJO_NATIVE"] = "1"
        ones = np.ones(batch, np.int32)
        times = {(name, what): [] for name in sessions for what in ("reserve", "step")}
        for _ in range(ALLOC_TURNS):
            for (name, what), got in times.items():
                session = sessions[name]
                session.renew()
                session._reserve(np.full(batch, ALLOC_CTX, np.int32))
                t0 = time.perf_counter()
                for _ in range(ALLOC_STEPS):
                    if what == "reserve":
                        session._reserve(ones)
                    else:
                        session.decode_arrays()
                got.append((time.perf_counter() - t0) / ALLOC_STEPS * 1e6)
        if not np.array_equal(sessions["native"].block_tables, sessions["numpy"].block_tables):
            raise AssertionError("tooling: the native and numpy allocators' tables differ")
        med = {k: float(np.median(v)) for k, v in times.items()}
        log("tooling", f"{card}: host us a decode step at bs {batch}, ctx {ALLOC_CTX} ({ALLOC_TURNS} turns of "
                       f"{ALLOC_STEPS}; median): reserve native {med['native', 'reserve']:.2f}, numpy "
                       f"{med['numpy', 'reserve']:.2f}; reserve + metadata native {med['native', 'step']:.2f}, numpy "
                       f"{med['numpy', 'step']:.2f}; turns "
                       f"{ {f'{a} {b}': [round(x, 2) for x in v] for (a, b), v in times.items()} }")
        del sessions


def _allocator_graph_steps(torch, card: str) -> None:
    """A reading, not a claim: the bf16 Qwen3-4B decode step on its CUDA graph at each of ALLOC_BATCHES, ctx
    ALLOC_CTX, from a session on each allocator, in turns (ALLOC_GRAPH_STEPS steps of each a turn, GRAPH_TURNS turns;
    each step synchronized, as the stepwise loop's token read is, and taken back after it); both sessions' logits and
    tables must agree."""
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import PagedAttentionGenerationModel, PagedAttentionRuntimeState

    config = Qwen3Config(**QWEN3_4B, dtype=torch.bfloat16, kv_layout="NHD")
    model = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    gm = PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE)
    for batch in ALLOC_BATCHES:
        ids, lens = _prompts(config.vocab_size, [ALLOC_CTX] * batch)
        runs = {}
        for mode in ("1", "0"):
            os.environ["MOJO_NATIVE"] = mode
            session = PagedAttentionRuntimeState.from_model(model, batch, block_size=BLOCK_SIZE)
            logits, _ = gm(ids, context_input_len=lens, session=session)
            token = torch.argmax(logits, -1).to(torch.int32)
            for _ in range(2):  # the graph's eager warm-up, then its capture
                step_logits, _ = gm(token, session=session)
                _rewind(session)
            runs[session.allocator] = (session, token, step_logits)
        os.environ["MOJO_NATIVE"] = "1"
        (native, _, a), (numpy_, _, b) = runs["native"], runs["numpy"]
        if not (torch.equal(a, b) and np.array_equal(native.block_tables, numpy_.block_tables)):
            raise AssertionError("tooling: the graph step's logits or tables differ between the allocators")
        times = {name: [] for name in runs}
        for _ in range(GRAPH_TURNS):
            for name, (session, token, _) in runs.items():
                for _ in range(ALLOC_GRAPH_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    gm(token, session=session)
                    torch.cuda.synchronize()
                    times[name].append((time.perf_counter() - t0) * 1e3)
                    _rewind(session)
        med = {k: float(np.median(v)) for k, v in times.items()}
        log("tooling", f"{card}: bf16 Qwen3-4B graph step at bs {batch}, ctx {ALLOC_CTX}, synchronized ({GRAPH_TURNS} "
                       f"turns of {ALLOC_GRAPH_STEPS}): median native {med['native']:.3f} ms, numpy "
                       f"{med['numpy']:.3f} ms; quartiles native {np.percentile(times['native'], [25, 75]).round(3)}, "
                       f"numpy {np.percentile(times['numpy'], [25, 75]).round(3)}")
        del runs, native, numpy_, a, b
        gc.collect()
        torch.cuda.empty_cache()
    del gm, model
    gc.collect()
    torch.cuda.empty_cache()


def phase_tooling(torch, card: str) -> dict:
    """Phase 19: the runtime tooling through the port's example entry points, under MOJO_NATIVE=1 (a native
    allocator that does not build fails the phase): ``llm_inference`` at its default width (``_tooling_llm``:
    graphs, counted; eager under the debugger; graphs under the debugger; profiler and chrome trace), the tiny
    examples (``_tooling_tiny``), then the allocator readings (``_allocator_host_us``, ``_allocator_graph_steps``).
    Returns the counted runs' launches by path."""
    from mojo_opset_tpu_torch.runtime import native

    before = os.environ.get("MOJO_NATIVE")
    os.environ["MOJO_NATIVE"] = "1"
    try:
        if not native.native_available():
            raise AssertionError("tooling: the native allocator is not available under MOJO_NATIVE=1")
        log("tooling", f"native allocator {native.library_path().relative_to(native.BUILD_DIR.parent.parent)}")
        counts = _tooling_llm(torch, card)
        _tooling_tiny(torch, card)
        _allocator_host_us(torch, card)
        _allocator_graph_steps(torch, card)
    finally:
        if before is None:
            os.environ.pop("MOJO_NATIVE", None)
        else:
            os.environ["MOJO_NATIVE"] = before
    return counts


# ---------------------------------------------------------------- phase 20: the rest of the ops

# JAX's MojoQwen3MoeBlock defaults (mojo_opset_tpu/modeling/qwen3/modeling_qwen3_moe.py:67-75), B 2 x S 1024
REST_MOE_BLOCK = dict(vocab_size=10000, hidden_size=4096, num_heads=32, head_dim=128, num_experts=8, top_k=2)
REST_MOE_BATCH = (2, 1024)
REST_ROUTE_SHARE = 0.99  # tokens whose top-2 experts the two tiers must agree on (a near-tie may flip one)
# bf16 on the card against the same op in fp32 on the CPU: whole tensor, worst row (PAGED_PREFILL_REL_LIMITS' bf16)
REST_REL_LIMITS = (1.5e-2, 3e-2)
REST_WINDOWS = dict(local_window_size=256, global_window_size=64)
REST_NSTEP = 4
# JAX's MojoIndexer defaults (mojo_opset_tpu/experimental/operators/indexer.py:63-70): a 2048-token causal prefill at
# bs 1, then 4 single-token steps. fp32 activations, as the module's weights: its int8 quant and its top-k are
# discrete, and bf16 inputs would move both
REST_INDEXER = dict(dim=7168, n_heads=128, head_dim=128, qk_rope_head_dim=64, topk=2048, q_lora_rank=1536)
REST_INDEXER_PREFILL, REST_INDEXER_STEPS = 2048, 4
# fp32 card against fp32 CPU: whole relative error of the finite scores; worst row's largest difference over the
# row's largest score (a key's int8 level moved by a rounding difference moves its scores by ~2e-3 of themselves)
REST_INDEXER_LIMITS = (1e-3, 5e-3)
# NSA at the NSA paper's settings (arXiv 2502.11089, section 4.1: compression block 32, selection block 64, 16
# selected blocks, window 512) with 64 heads of 128; paged decode at bs 4 over ctx 8192, a paged prefill of 128 new
# tokens on a 2048-key sequence. fp32: the block selection is discrete and bf16 moves blocks across the cut
REST_NSA = dict(num_heads=64, head_dim=128, compress_ratio=32, num_selected_blocks=16, block_size=64, window_size=512)
REST_NSA_DECODE = (4, 8192)
REST_NSA_PREFILL = (128, 2048)
REST_NSA_LIMITS = (1e-4, 5e-3)  # whole relative error; share of (token, head) rows off by over 1e-4 of their norm
# over-encoding at Qwen3-4B's vocabulary and width with JAX's perf descriptor's tables
# (tests/perf_new/operators/over_encoding.py:33-35), B 4 x T 512, NF4 groups of 64
REST_OE = dict(ori_vocab_size=151936, ori_embed_dim=2560, oe_embed_dim=256, oe_vocab_sizes=[100003, 100019],
               oe_grams=[2, 3])
REST_OE_BATCH, REST_OE_VARLEN, REST_NF4_GROUP = (4, 512), (300, 1, 211), 64
ROUNDING = dict(atol=1e-5, rtol=2**-7)  # one bf16 rounding of an fp32 result (and fp32 noise near zero)


def _rest_ms(torch, fn, iters: int = 3) -> float:
    return cuda_ms(torch, fn, iters=iters, warmup=1)


def _rest_cpu(t):
    """A CUDA tensor's CPU copy, floats in fp32."""
    return t.cpu().float() if t.is_floating_point() else t.cpu()


def _rest_rel(name: str, got, want, ms: float, limits=REST_REL_LIMITS) -> None:
    """Hold ``got`` (the card) to ``want`` (the CPU in fp32) relative to its size, and log the readings."""
    got, want = got.float().cpu(), want.float().cpu()
    whole, row, rms = rel_errors(got, want)
    err = (got - want).abs().max().item()
    if not (whole <= limits[0] and row <= limits[1]):
        raise AssertionError(f"rest ops: {name}: relative {whole:.3g} (worst row {row:.3g}) over {limits}")
    log("rest ops", f"{name}: max_abs_err {err:.3g}, relative {whole:.3g} / worst row {row:.3g} (limits {limits}, "
                    f"rms {rms:.3g}); {ms:.3f} ms")


def _rest_close(name: str, got, want, ms: float, tol: dict) -> None:
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff

    got = [g.float().cpu() for g in (got if isinstance(got, (list, tuple)) else [got])]
    want = [w.float().cpu() for w in (want if isinstance(want, (list, tuple)) else [want])]
    for g, w in zip(got, want):
        check_tol_diff(g, w, **tol)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    log("rest ops", f"{name}: max_abs_err {err:.3g} (limit {tol}); {ms:.3f} ms")


def _rest_moe_block(torch, card: str) -> dict:
    """MojoQwen3MoeBlock's cuda tier (kernels A, J and H, no golden route) against its ref tier on the same
    tensors; returns the cuda run's launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaGroupGemm, CudaPrefillGQA, CudaRMSNorm
    from mojo_opset_tpu_torch.modeling.qwen3 import MojoQwen3MoeBlock
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    gen = torch.Generator(device="cuda").manual_seed(0)
    block = MojoQwen3MoeBlock(**REST_MOE_BLOCK, device="cuda", generator=gen)
    with plain_tier():
        plain = MojoQwen3MoeBlock(**REST_MOE_BLOCK, device="cuda")
    plain.load_state_dict(block.state_dict())
    classes = (CudaRMSNorm, CudaPrefillGQA, CudaGroupGemm)
    if not all(isinstance(op, cls) for op, cls in zip((block.pre_norm, block.attn, block.moe_gmm), classes)):
        raise AssertionError("moe block: the cuda tier's block does not hold the cuda classes")
    ids = torch.randint(0, REST_MOE_BLOCK["vocab_size"], REST_MOE_BATCH, device="cuda", generator=gen)
    routes = {}
    hooks = [m.moe_gate.register_forward_hook(lambda mod, inp, out, key=key: routes.__setitem__(key, out[0]))
             for key, m in (("cuda", block), ("plain", plain))]
    goldens = golden_counts()
    kernels.reset_launch_counts()
    got = block(ids)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if set(counts) != {"norms", "flash_swa_fwd", "group_gemm"}:
        raise AssertionError(f"moe block: launched {counts}, want A, J and H")
    if golden_counts() != goldens:
        raise AssertionError(f"moe block: a golden route was taken: {golden_counts()} from {goldens}")
    want = plain(ids)
    for h in hooks:
        h.remove()
    agree = (routes["cuda"].sort(dim=-1).values == routes["plain"].sort(dim=-1).values).all(dim=-1)
    share = agree.float().mean().item()
    if share < REST_ROUTE_SHARE:
        raise AssertionError(f"moe block: the tiers agree on {share:.4f} of the routes, under {REST_ROUTE_SHARE}")
    g, w = got.reshape(-1, got.shape[-1])[agree], want.reshape(-1, want.shape[-1])[agree]
    check_tol_diff(g, w, **tols_for(torch.bfloat16))
    whole, row, _ = rel_errors(g, w)
    ms, plain_ms = _rest_ms(torch, lambda: block(ids)), _rest_ms(torch, lambda: plain(ids))
    log("rest ops", f"{card}: MojoQwen3MoeBlock {REST_MOE_BLOCK} at B {REST_MOE_BATCH[0]} x S {REST_MOE_BATCH[1]} "
                    f"bf16: launches {counts}; routes agree on {share:.4f} of the tokens (bound {REST_ROUTE_SHARE}); "
                    f"those rows: max_abs_err {(g.float() - w.float()).abs().max().item():.3g} (bf16 ladder), "
                    f"relative {whole:.3g} / worst row {row:.3g}; {ms:.3f} ms on A, J and H, {plain_ms:.3f} ms on the "
                    f"goldens")
    del block, plain, got, want
    return counts


def _rest_paged(torch, card: str) -> dict:
    """The masked paged ops, the windowed prefills and the n-step decode at Qwen3-4B's attention geometry in bf16,
    each against the same op in fp32 on the CPU; windowless PagedPrefillSWA against kernel D and the one-step
    NstepSWA against kernel C. Returns C's and D's launches in those cross-checks."""
    from mojo_opset_tpu_torch import (MojoPagedDecodeGQA, MojoPagedDecodeSWA, MojoPagedPrefillGQA,
                                      MojoPagedPrefillSWA)
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaPagedDecodeGQA, CudaPagedPrefillGQA
    from mojo_opset_tpu_torch.experimental import MojoPagedDecodeNstepSWA, MojoPagedPrefillSWAWithKVDequant

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, H, Hkv, D, bs = torch.bfloat16, 32, 8, 128, BLOCK_SIZE
    lens = list(PROMPT_LENS)
    n_cols = -(-max(lens) // bs)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    kc, vc = _cache(torch, n_blocks, Hkv, bs, D, "NHD", bf16, gen)
    kh, vh = _cache(torch, n_blocks, Hkv, bs, D, "HND", bf16, gen)
    (k8, v8), (ks, vs) = _int8_cache(torch, n_blocks, Hkv, bs, D, gen)
    table = _tables(torch, lens, bs, n_cols, n_blocks, gen)
    tl, cu = torch.tensor(lens, dtype=torch.int32, device="cuda"), _cu(torch, lens)
    q_dec = torch.randn(len(lens), H, D, device="cuda", generator=gen).to(bf16)
    q_pf = torch.randn(sum(lens), H, D, device="cuda", generator=gen).to(bf16)
    q_nstep = torch.randn(len(lens), REST_NSTEP, H, D, device="cuda", generator=gen).to(bf16)
    rows, cols = max(lens) + 1, n_cols * bs
    masks = {"decode": {f: torch.rand(*s, rows, cols, device="cuda", generator=gen) < 0.2
                        for f, s in (("2-D", ()), ("3-D", (len(lens),)))},
             "prefill": {f: torch.rand(*s, rows, cols, device="cuda", generator=gen) < 0.8
                         for f, s in (("2-D", ()), ("3-D", (len(lens),)))}}
    golden_before = {cls: cls.golden_calls for cls in (CudaPagedDecodeGQA, CudaPagedPrefillGQA)}

    def both(name, build, *args, ref_build=None):
        """``build()``'s op on the card's args and the same op in fp32 on the CPU's copies."""
        op = build()
        got = op(*args)
        want = (ref_build or build)()(*[_rest_cpu(a) if isinstance(a, torch.Tensor) else a for a in args])
        _rest_rel(f"{card}: {name}", got, want, _rest_ms(torch, lambda: op(*args)))

    for form, mask in masks["decode"].items():
        both(f"MojoPagedDecodeGQA non-causal, {form} mask (True = exclude), bs 4 at ctx {lens}",
             lambda: MojoPagedDecodeGQA(is_causal=False, kv_layout="NHD"), q_dec, kc, vc, tl, table, None, mask)
    for form, mask in masks["prefill"].items():
        both(f"MojoPagedPrefillGQA non-causal, {form} mask (True = keep), prompts {lens}",
             lambda: MojoPagedPrefillGQA(is_causal=False, kv_layout="NHD"), q_pf, kc, vc, cu, table, None, None, mask)
    for cls, n in ((CudaPagedDecodeGQA, 2), (CudaPagedPrefillGQA, 2)):
        taken = cls.golden_calls - golden_before[cls]
        if taken < n:
            raise AssertionError(f"{cls.__name__}: {taken} golden routes counted, want the {n} masked calls and more")
        log("rest ops", f"{cls.__name__}.golden_calls rose by {taken} (the masked calls, checked and timed)")
    both(f"MojoPagedPrefillSWA {REST_WINDOWS}, prompts {lens}",
         lambda: MojoPagedPrefillSWA(kv_layout="NHD", **REST_WINDOWS), q_pf, kc, vc, cu, table)
    both(f"MojoPagedPrefillSWAWithKVDequant {REST_WINDOWS} on int8 pages",
         lambda: MojoPagedPrefillSWAWithKVDequant(**REST_WINDOWS), q_pf, None, k8, ks, v8, vs, cu, table)
    both(f"MojoPagedDecodeNstepSWA S {REST_NSTEP} {REST_WINDOWS}",
         lambda: MojoPagedDecodeNstepSWA(**REST_WINDOWS), q_nstep, kh, vh, tl, table)

    counts = {}
    kernels.reset_launch_counts()
    on_d = MojoPagedPrefillGQA(kv_layout="NHD")(q_pf, kc, vc, cu, table, max_q_len=max(lens))
    counts["paged_prefill"] = kernels.launch_counts()["paged_prefill"]
    windowless = MojoPagedPrefillSWA(kv_layout="NHD")(q_pf, kc, vc, cu, table)
    _rest_rel(f"{card}: windowless MojoPagedPrefillSWA (golden) against CudaPagedPrefillGQA (D)", on_d, windowless,
              _rest_ms(torch, lambda: MojoPagedPrefillSWA(kv_layout="NHD")(q_pf, kc, vc, cu, table)))
    kernels.reset_launch_counts()
    on_c = MojoPagedDecodeSWA(kv_layout="HND", **REST_WINDOWS)(q_nstep[:, 0].contiguous(), kh, vh, tl, table)
    counts["paged_decode"] = kernels.launch_counts()["paged_decode"]
    one_step = MojoPagedDecodeNstepSWA(**REST_WINDOWS)(q_nstep[:, :1], kh, vh, tl, table)[:, 0]
    _rest_rel(f"{card}: MojoPagedDecodeNstepSWA S 1 (golden) against CudaPagedDecodeSWA (C)", on_c, one_step,
              _rest_ms(torch, lambda: MojoPagedDecodeNstepSWA(**REST_WINDOWS)(q_nstep[:, :1], kh, vh, tl, table)))
    if not (counts["paged_prefill"] and counts["paged_decode"]):
        raise AssertionError(f"rest ops: the cross-checks launched {counts}, want C and D")
    return counts


def _rest_indexer(torch, card: str) -> None:
    """MojoIndexer at JAX's defaults: a causal prefill then single-token steps, on the card and on the CPU in fp32;
    scores to REST_INDEXER_LIMITS, the top-k as described at ``_topk_agree``."""
    from mojo_opset_tpu_torch.backends.cuda.operators import CudaApplyRoPE
    from mojo_opset_tpu_torch.experimental import MojoIndexer

    gen = torch.Generator(device="cuda").manual_seed(0)
    S_all = REST_INDEXER_PREFILL + REST_INDEXER_STEPS
    idx = MojoIndexer(**REST_INDEXER, max_batch_size=1, max_seq_len=S_all, device="cuda", generator=gen)
    ref = MojoIndexer(**REST_INDEXER, max_batch_size=1, max_seq_len=S_all, device="cpu")
    ref.load_state_dict({k: v.cpu() for k, v in idx.state_dict().items()})
    caches, ref_caches = idx.init_cache(), ref.init_cache()
    x = torch.randn(1, S_all, REST_INDEXER["dim"], device="cuda", generator=gen)
    qr = torch.randn(1, S_all, REST_INDEXER["q_lora_rank"], device="cuda", generator=gen)
    angles = torch.rand(S_all, REST_INDEXER["qk_rope_head_dim"] // 2, device="cuda", generator=gen) * 6
    freqs = torch.polar(torch.ones_like(angles), angles)
    P = REST_INDEXER_PREFILL
    mask = torch.full((P, P), float("-inf"), device="cuda").triu(1)
    rope_before = CudaApplyRoPE.golden_calls
    for start, S in ((0, P), *((P + i, 1) for i in range(REST_INDEXER_STEPS))):
        args = (x[:, start:start + S], qr[:, start:start + S], start, freqs[start:start + S],
                mask if S > 1 else None)
        t0 = time.perf_counter()
        top, score, *caches = idx(*args, *caches)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        calls = CudaApplyRoPE.golden_calls
        ref_top, ref_score, *ref_caches = ref(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args],
                                              *ref_caches)
        CudaApplyRoPE.golden_calls = calls  # the CPU run's RoPE calls are not the card's
        score, top = score.cpu(), top.cpu()
        finite = torch.isfinite(ref_score)
        if not torch.equal(finite, torch.isfinite(score)):
            raise AssertionError(f"indexer at {start}: the -inf entries differ")
        diff = (score - ref_score).where(finite, torch.zeros(()))
        whole = (diff.norm() / ref_score.where(finite, torch.zeros(())).norm()).item()
        row_max = ref_score.where(finite, torch.zeros(())).abs().amax(dim=-1).clamp_min(1e-30)
        worst = (diff.abs().amax(dim=-1) / row_max).max().item()
        if not (whole <= REST_INDEXER_LIMITS[0] and worst <= REST_INDEXER_LIMITS[1]):
            raise AssertionError(f"indexer at {start}: scores relative {whole:.3g} / worst row {worst:.3g} over "
                                 f"{REST_INDEXER_LIMITS}")
        same = _topk_agree(torch, f"indexer at {start}", top, ref_top, ref_score, row_max)
        log("rest ops", f"{card}: MojoIndexer {REST_INDEXER} fp32, positions [{start}, {start + S}): index_score "
                        f"max_abs_err {diff.abs().max().item():.3g}, relative {whole:.3g} / worst row {worst:.3g} "
                        f"(limits {REST_INDEXER_LIMITS}); top-{top.shape[-1]}: {same:.6f} of the ranks hold the CPU's "
                        f"index, the rest a CPU score within {REST_INDEXER_LIMITS[1]} of the row's largest of the "
                        f"CPU's own; {ms:.1f} ms (one call, first)")
    calls = CudaApplyRoPE.golden_calls - rope_before
    if calls != 1 + REST_INDEXER_STEPS:
        raise AssertionError(f"indexer: CudaApplyRoPE.golden_calls rose by {calls}, want one a call")
    log("rest ops", f"CudaApplyRoPE.golden_calls rose by {calls} over the indexer's calls (partial 64-wide tables on "
                    f"4-D token-first 128-wide heads: the golden route)")


def _topk_agree(torch, name, top, ref_top, ref_score, row_max) -> float:
    """The card's top-k against the CPU's: at every rank the CPU's score of the card's index is within
    REST_INDEXER_LIMITS[1] x the row's largest score of the CPU's score at that rank (scores that close may take
    either order across devices), and every ``-inf`` rank holds the CPU's index exactly (lower index first).
    Returns the share of ranks holding the same index."""
    card_scores, ref_scores = ref_score.gather(-1, top), ref_score.gather(-1, ref_top)
    inf = torch.isinf(ref_scores)
    if not torch.equal(torch.isinf(card_scores), inf) or not torch.equal(top[inf], ref_top[inf]):
        raise AssertionError(f"{name}: the -inf ranks differ")
    gap = (card_scores - ref_scores).where(~inf, torch.zeros(())).abs() / row_max[..., None]
    if gap.max().item() > REST_INDEXER_LIMITS[1]:
        raise AssertionError(f"{name}: a rank's score parts from the CPU's by {gap.max().item():.3g} of its row's "
                             f"largest")
    return (top == ref_top).float().mean().item()


def _rest_nsa(torch, card: str) -> None:
    """NSA's paged decode and paged prefill at the paper's settings, fp32 on the card and on the CPU."""
    from mojo_opset_tpu_torch.experimental import MojoPagedDecodeNSA, MojoPagedPrefillNSA

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, D, bs = REST_NSA["num_heads"], REST_NSA["head_dim"], BLOCK_SIZE
    B, ctx = REST_NSA_DECODE
    n_blocks = B * ctx // bs
    kc = torch.randn(n_blocks, H, bs, D, device="cuda", generator=gen)
    vc = torch.randn(n_blocks, H, bs, D, device="cuda", generator=gen)
    table = torch.randperm(n_blocks, device="cuda", generator=gen).to(torch.int32).reshape(B, ctx // bs)
    ref_caches = (kc.cpu(), vc.cpu())
    for cls, name in ((MojoPagedDecodeNSA, "decode"), (MojoPagedPrefillNSA, "prefill")):
        op = cls(**REST_NSA, device="cuda", generator=gen)
        ref = cls(**REST_NSA, device="cpu")
        ref.load_state_dict({k: v.cpu() for k, v in op.state_dict().items()})
        if name == "decode":
            args = (torch.randn(B, H, D, device="cuda", generator=gen), kc, vc,
                    torch.full((B,), ctx, dtype=torch.int32, device="cuda"), table)
            what = f"paged decode bs {B} at ctx {ctx}"
        else:
            q_len, kv_len = REST_NSA_PREFILL
            args = (torch.randn(q_len, H, D, device="cuda", generator=gen), kc, vc,
                    torch.tensor([0, q_len], dtype=torch.int32, device="cuda"), table[:1, : kv_len // bs], None,
                    torch.tensor([0, kv_len], dtype=torch.int32, device="cuda"))
            what = f"paged prefill of {q_len} tokens on a {kv_len}-key sequence (the golden loops a token)"
        t0 = time.perf_counter()
        got = op(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        cpu_args = [ref_caches[0] if a is kc else ref_caches[1] if a is vc else
                    a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        want = ref(*cpu_args)
        got = got.cpu()
        whole = ((got - want).norm() / want.norm()).item()
        rows = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        off = (rows > 1e-4).float().mean().item()
        if not (whole <= REST_NSA_LIMITS[0] and off <= REST_NSA_LIMITS[1]):
            raise AssertionError(f"nsa {name}: relative {whole:.3g}, {off:.4f} of the rows off, over {REST_NSA_LIMITS}")
        log("rest ops", f"{card}: NSA {REST_NSA} fp32 {what}: max_abs_err {(got - want).abs().max().item():.3g}, "
                        f"relative {whole:.3g}, (token, head) rows off by over 1e-4: {off:.4f} (limits "
                        f"{REST_NSA_LIMITS}); {ms:.1f} ms (one call, first)")


def _rest_sage(torch, card: str) -> None:
    """Sage prefill at Qwen3-4B's geometry, int8 q, k, v with their scales, on the card and on the CPU: the bf16
    outputs within the bound argued in tests/test_torch_experimental_ops.py (one exp level and one bf16 rounding),
    and 99% of them within one rounding."""
    from mojo_opset_tpu_torch.experimental import MojoPagedPrefillSageGQA
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, Hkv, D, bs = 32, 8, 128, BLOCK_SIZE
    lens = list(PROMPT_LENS)
    n_blocks = sum(-(-n // bs) for n in lens) + 8
    T = sum(lens)

    def i8(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=gen, dtype=torch.int8)

    def scale(*shape):
        return torch.rand(*shape, device="cuda", generator=gen) * 0.015 + 0.005

    args = (i8(T, H, D), scale(H, T), i8(n_blocks, Hkv, bs, D), scale(n_blocks, Hkv, bs), i8(n_blocks, Hkv, bs, D),
            scale(Hkv, D), _cu(torch, lens), _tables(torch, lens, bs, -(-max(lens) // bs), n_blocks, gen))
    op = MojoPagedPrefillSageGQA()
    got = op(*args)
    want = op(*[a.cpu() for a in args])
    vmax = float(args[4].abs().max().item() * args[5].max().item())
    tol = dict(atol=2 * vmax / 127, rtol=2**-7)
    check_tol_diff(got.cpu(), want, ptol=0.99, atol=1e-6, rtol=2**-7)
    _rest_close(f"{card}: MojoPagedPrefillSageGQA prompts {lens}, 32/8 heads x 128 (99% within one bf16 "
                       f"rounding)", got, want, _rest_ms(torch, lambda: op(*args)), tol)


def _rest_over_encoding(torch, card: str) -> None:
    """MojoOverEncoding at Qwen3-4B's vocabulary and width, dense and NF4, in bf16 on the card against fp32 on the
    CPU; its n-gram ids exactly."""
    from mojo_opset_tpu_torch import MojoOverEncoding, MojoOverEncodingNGram

    gen = torch.Generator(device="cuda").manual_seed(0)
    V = REST_OE["ori_vocab_size"]
    B, T = REST_OE_BATCH
    ids = torch.randint(0, V, (B, T), device="cuda", generator=gen, dtype=torch.int32)
    hist = torch.randint(0, V, (B, 2), device="cuda", generator=gen, dtype=torch.int32)
    lens = torch.tensor(REST_OE_VARLEN, dtype=torch.int32)
    packed = torch.randint(0, V, (int(lens.sum()),), device="cuda", generator=gen, dtype=torch.int32)
    packed_hist = torch.randint(0, V, (len(REST_OE_VARLEN), 2), device="cuda", generator=gen, dtype=torch.int32)
    ngram = MojoOverEncodingNGram(V, REST_OE["oe_vocab_sizes"], REST_OE["oe_grams"])
    for a, h, n in ((ids, hist, None), (packed, packed_hist, lens)):
        if not torch.equal(ngram(a, h, n).cpu(), ngram(a.cpu(), h.cpu(), n)):
            raise AssertionError("over-encoding: the card's n-gram ids differ from the CPU's")
    rows, dim = sum(REST_OE["oe_vocab_sizes"]), REST_OE["oe_embed_dim"]
    nf4 = dict(_mega_embedding_weight=torch.randint(-128, 128, (rows, dim // 2), device="cuda", generator=gen,
                                                    dtype=torch.int8),
               _mega_embedding_scale=torch.rand(rows, dim // REST_NF4_GROUP, device="cuda", generator=gen) + 0.5,
               _mega_embedding_mean=torch.randn(rows, dim // REST_NF4_GROUP, device="cuda", generator=gen) * 0.1,
               _mega_embedding_group_size=REST_NF4_GROUP)
    for label, extra in (("dense", {}), (f"NF4 (group {REST_NF4_GROUP})", nf4)):
        op = MojoOverEncoding(**REST_OE, **extra, device="cuda", dtype=torch.bfloat16, generator=gen)
        cpu_extra = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in extra.items()}
        ref = MojoOverEncoding(**REST_OE, **cpu_extra, device="cpu", dtype=torch.float32)
        ref.load_state_dict({k: v.cpu() for k, v in op.state_dict().items()})
        for what, args in ((f"B {B} x T {T}", (ids, hist)), (f"varlen {REST_OE_VARLEN}", (packed, packed_hist, lens))):
            got = op(*args)
            want = ref(*[a.cpu() for a in args])
            _rest_rel(f"{card}: MojoOverEncoding {label} bf16, {what}", got, want, _rest_ms(torch, lambda: op(*args)))
        del op, ref


def _rest_small_ops(torch, card: str) -> None:
    """The rotate activation at DeepSeek-V3's 7168, the attention gate, the group and in-place norms and MRoPE in
    place at Qwen3-4B's widths in bf16 (within one bf16 rounding of the fp32 CPU run: they compute in fp32 and round
    once), StoreLowrank and the reduce-sum GEMM (exactly: copies; int8 sums exact in fp32 at K 1024)."""
    from mojo_opset_tpu_torch.experimental import (MojoFusedAttnOutputGate, MojoGroupLayerNorm,
                                                   MojoGroupRMSNormInplace, MojoMRoPEInplace,
                                                   MojoQuantBatchGemmReduceSum, MojoRMSNormInplace,
                                                   MojoRotateActivation, MojoStoreLowrank)

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, T, hidden = torch.bfloat16, sum(PROMPT_LENS), 2560

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    def run(name, op, ref, args, tol=ROUNDING):
        got = op(*args)
        want = ref(*[[_rest_cpu(t) for t in a] if isinstance(a, list) and isinstance(a[0], torch.Tensor) else
                     _rest_cpu(a) if isinstance(a, torch.Tensor) else a for a in args])
        _rest_close(f"{card}: {name}", got, want, _rest_ms(torch, lambda: op(*args)), tol)

    def pair(cls, *a, **kw):
        op = cls(*a, **kw, device="cuda")
        with torch.no_grad():
            for p in op.parameters():
                p.copy_(torch.randn(p.shape, device="cuda", generator=gen) * 0.2 + 1.0)
        ref = cls(*a, **kw, device="cpu")
        ref.load_state_dict({k: v.cpu().float() for k, v in op.state_dict().items()})
        return op, ref

    rot = MojoRotateActivation()
    run("MojoRotateActivation at 7168 (padded to 8192), 1024 rows", rot, rot, (randn(1024, 7168),))
    gate = MojoFusedAttnOutputGate(hidden, 16, 16, 128, bias=True, device="cuda", dtype=bf16, generator=gen)
    gate_ref = MojoFusedAttnOutputGate(hidden, 16, 16, 128, bias=True, device="cpu")
    gate_ref.load_state_dict({k: v.cpu().float() for k, v in gate.state_dict().items()})
    run(f"MojoFusedAttnOutputGate hidden {hidden}, 16 + 16 heads x 128, T {T}", gate, gate_ref,
        (randn(T, hidden), randn(T, 16, 128), randn(T, 16 * 128)))
    for cls in (MojoGroupLayerNorm, MojoGroupRMSNormInplace):
        op, ref = pair(cls, 2, hidden, 1e-6)
        run(f"{cls.__name__} 2 groups of {hidden}, T {T}", op, ref, ([randn(T, hidden), randn(T, hidden) * 3 + 1],))
    op, ref = pair(MojoRMSNormInplace, hidden, 1e-6, inplace=True)
    run(f"MojoRMSNormInplace {hidden}, T {T}", op, ref, (randn(T, hidden),))
    sections, mrope = [16, 24, 24], MojoMRoPEInplace(inplace=True)
    run(f"MojoMRoPEInplace sections {sections} on 32/8 heads x 128, T {T}", mrope, mrope,
        (randn(T, 32 * 128), randn(T, 8 * 128), randn(3, T, 64, dtype=torch.float32),
         randn(3, T, 64, dtype=torch.float32), sections, False, 128))

    n_blocks, heads, slots, d = 64, 8, 64, 128
    perm = torch.randperm(n_blocks * slots, device="cuda", generator=gen)[:T]
    blocks = (perm // slots).to(torch.int32)
    blocks[torch.rand(T, device="cuda", generator=gen) < 0.1] = -1
    tokens = (perm % slots).to(torch.int32)
    cache, key_lr = randn(n_blocks, heads, slots, d), randn(T, heads, d)
    want = cache.cpu()  # the writes of the valid tokens alone, each slot written once
    valid = (blocks >= 0).cpu()
    want[blocks.cpu()[valid].long(), :, tokens.cpu()[valid].long()] = key_lr.cpu()[valid]
    store = MojoStoreLowrank()
    got = store(cache, key_lr, blocks, tokens, T)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("StoreLowrank: the card's cache is not the valid tokens' writes (a -1 block written?)")
    log("rest ops", f"{card}: MojoStoreLowrank ({n_blocks}, {heads}, {slots}, {d}) bf16, {T} tokens, "
                    f"{(blocks < 0).sum().item()} on block -1: equal to the CPU's bit for bit; "
                    f"{_rest_ms(torch, lambda: store(cache, key_lr, blocks, tokens, T)):.3f} ms")

    B, M, K, N = 8, 1024, 1024, hidden
    w = torch.randint(-128, 128, (B, K, N), device="cuda", generator=gen, dtype=torch.int8)
    x = torch.randint(-128, 128, (B, M, K), device="cuda", generator=gen, dtype=torch.int8)
    s1 = torch.rand(B, M, device="cuda", generator=gen) * 1e-3
    s2 = torch.rand(N, device="cuda", generator=gen) * 1e-3
    gemm, gemm_ref = MojoQuantBatchGemmReduceSum(w), MojoQuantBatchGemmReduceSum(w.cpu())
    run(f"MojoQuantBatchGemmReduceSum B {B} x ({M}, {K}) x ({K}, {N}) int8 -> bf16 (exact)", gemm, gemm_ref,
        (x, s1, s2), tol=dict(atol=0.0, rtol=0.0))


def phase_rest_ops(torch, card: str) -> dict:
    """Phase 20: the ops ported last (see the module docstring). Returns the launches of the MoE block's cuda run
    (A, J, H) and of the C and D cross-checks."""
    with torch.no_grad():
        counts = _rest_moe_block(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        counts.update(_rest_paged(torch, card))
        _rest_indexer(torch, card)
        gc.collect()
        torch.cuda.empty_cache()
        _rest_nsa(torch, card)
        _rest_sage(torch, card)
        _rest_over_encoding(torch, card)
        _rest_small_ops(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 21: an HF checkpoint on disk

# huggingface.co/Qwen/Qwen3-4B config.json (published values; weights drawn from seed 0, not the published ones)
HF_QWEN3_4B = dict(
    architectures=["Qwen3ForCausalLM"], model_type="qwen3", hidden_size=2560, intermediate_size=9728,
    num_hidden_layers=36, num_attention_heads=32, num_key_value_heads=8, head_dim=128, vocab_size=151936,
    max_position_embeddings=40960, rope_theta=1000000, rms_norm_eps=1e-6, tie_word_embeddings=True,
    attention_bias=False, hidden_act="silu", torch_dtype="bfloat16", bos_token_id=151643, eos_token_id=151645,
)
# huggingface.co/Qwen/Qwen3-30B-A3B config.json, its 48 layers cut to HF_MOE_LAYERS (reduced depth only)
HF_QWEN3_30B_A3B = dict(
    architectures=["Qwen3MoeForCausalLM"], model_type="qwen3_moe", hidden_size=2048, intermediate_size=6144,
    num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4, head_dim=128, vocab_size=151936,
    max_position_embeddings=40960, rope_theta=1000000, rms_norm_eps=1e-6, tie_word_embeddings=False,
    attention_bias=False, hidden_act="silu", torch_dtype="bfloat16", num_experts=128, num_experts_per_tok=8,
    moe_intermediate_size=768, norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[],
    bos_token_id=151643, eos_token_id=151645,
)
HF_MOE_LAYERS = 4
# mixed-length prompts through the byte-level fallback tokenizer (a byte a token): 316, 44, 9 and 1 tokens
HF_PROMPTS = ["Paged attention keeps each sequence's keys and values in fixed-size blocks. " * 4 + "Go on:" * 2,
              "The quick brown fox jumps over the lazy dog.", "Hi there!", "a"]
HF_STEPS = 16
HF_TOP_K = 50  # the deterministic child's sampled serves (llm_inference's default sampler)
HF_DISK_MARGIN = 1.25  # free space wanted beyond the checkpoint's bytes
HF_CHILD_TIMEOUT_S = 300


def _safetensors_file(torch, path: str, tensors: dict) -> int:
    """A minimal safetensors writer: the 8-byte little-endian header length,
    the JSON header (padded with spaces to 8 bytes), then each tensor's
    bytes in header order. Returns the bytes written."""
    import struct

    names = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32", torch.int8: "I8"}
    header, offset = {}, 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(blob) + offset


def _write_hf_checkpoint(torch, path: str, tensors: dict, hf_config: dict) -> int:
    """``tensors`` as two shards split at half the bytes, with
    ``model.safetensors.index.json`` and ``config.json``; returns the shards' bytes."""
    import itertools

    names = list(tensors)
    cumulative = list(itertools.accumulate(tensors[n].numel() * tensors[n].element_size() for n in names))
    total = cumulative[-1]
    split = next(i for i, c in enumerate(cumulative) if c >= total / 2) + 1
    shards = {"model-00001-of-00002.safetensors": names[:split], "model-00002-of-00002.safetensors": names[split:]}
    written = sum(_safetensors_file(torch, os.path.join(path, shard), {n: tensors[n] for n in keys})
                  for shard, keys in shards.items())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": {n: shard for shard, keys in shards.items() for n in keys}}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f)
    return written


def _hf_moe_tensors(torch, model) -> dict:
    """A Qwen3-MoE model's state under HF's names: the ``model.`` prefix,
    the experts per expert (``mlp.experts.{e}.{gate,up,down}_proj.weight``),
    the router as ``mlp.gate.weight`` (E, H), in the model's dtype."""
    import re

    out = {}
    for name, t in model.state_dict().items():
        m = re.fullmatch(r"layers\.(\d+)\.mlp\.(experts\.up_proj_weight|experts\.down_proj_weight|gating\.gate_weight)",
                         name)
        if m is None:
            out[name if name.startswith("lm_head.") else f"model.{name}"] = t
            continue
        prefix = f"model.layers.{m.group(1)}.mlp"
        if m.group(2) == "gating.gate_weight":
            out[f"{prefix}.gate.weight"] = t.T.to(torch.bfloat16)
        elif m.group(2) == "experts.up_proj_weight":  # (E, 2I, H): the gate rows, then the up rows
            inter = t.shape[1] // 2
            for e in range(t.shape[0]):
                out[f"{prefix}.experts.{e}.gate_proj.weight"] = t[e, :inter]
                out[f"{prefix}.experts.{e}.up_proj.weight"] = t[e, inter:]
        else:
            for e in range(t.shape[0]):
                out[f"{prefix}.experts.{e}.down_proj.weight"] = t[e]
    return out


def _bit_equal(torch, a, b) -> bool:
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return a.numel() == 0 or torch.equal(a.contiguous().view(ints[a.element_size()]),
                                         b.contiguous().view(ints[b.element_size()]))


def _hf_serve(torch, model, fused: bool, typewriter: bool = False, top_k: int = 0):
    """HF_PROMPTS through ``MojoGenerator.__call__`` (the fallback
    tokenizer, greedy or with ``top_k`` top-k sampling from the generator's
    seed 0, HF_STEPS tokens, graphs as the entry point serves by default):
    (tokens, kept logits). The typewriter's text goes to a buffer."""
    import io

    from mojo_opset_tpu_torch.examples.llm_inference import _FallbackTokenizer
    from mojo_opset_tpu_torch.runtime import GreedySampler, MojoGenerator, PagedAttentionGenerationModel, TopKSampler

    keep = _keep_logits()
    sampler = TopKSampler(top_k) if top_k else GreedySampler()
    gen = MojoGenerator(PagedAttentionGenerationModel(model, block_size=BLOCK_SIZE), _FallbackTokenizer(),
                        sampler, max_new_tokens=HF_STEPS, enable_typewriter=typewriter, hooks=[keep])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        tokens = gen(HF_PROMPTS, ignore_eos=True, fused_decode=fused)
    torch.cuda.synchronize()
    if typewriter and "Generation is done." not in printed.getvalue():
        raise AssertionError("hf checkpoint: the typewriter printed no text")
    return tokens, keep.steps


def _hf_round_trip(torch, card: str, tag: str, source, path: str, tensors: dict, hf_config: dict, load, path_kernels,
                   typewriter_check: bool = False) -> dict:
    """Write ``tensors`` as an HF checkpoint, load it with ``load`` (strict),
    hold every parameter to ``source``'s bit for bit, then serve both
    (stepwise and fused) and hold tokens and logits bit for bit; the loaded
    model's stepwise serve counted (every kernel of ``path_kernels`` must
    launch). Returns the counts."""
    import shutil

    from mojo_opset_tpu_torch.backends.cuda import kernels

    need = sum(t.numel() * t.element_size() for t in tensors.values())
    free = shutil.disk_usage(path).free
    if free < need * HF_DISK_MARGIN:
        raise AssertionError(f"{tag}: {free / 1e9:.2f} GB free under {path}, the checkpoint needs "
                             f"{need / 1e9:.2f} GB (x{HF_DISK_MARGIN})")
    t0 = time.perf_counter()
    written = _write_hf_checkpoint(torch, path, tensors, hf_config)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = load(path, device="cuda", strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(tag, f"{card}: {written / 1e9:.3f} GB in 2 shards written in {write_s:.1f} s ({written / 1e9 / write_s:.2f} "
             f"GB/s, from the card through the host), loaded onto the card in {load_s:.1f} s "
             f"({written / 1e9 / load_s:.2f} GB/s; the read warm, from the page cache just written)")
    src_state, state = source.state_dict(), model.state_dict()
    if set(src_state) != set(state):
        raise AssertionError(f"{tag}: state names differ: {sorted(set(src_state) ^ set(state))[:6]}")
    off = [n for n in src_state if not _bit_equal(torch, src_state[n], state[n])]
    if off:
        raise AssertionError(f"{tag}: {len(off)} tensors differ from the source model's: {off[:6]}")
    log(tag, f"all {len(state)} state tensors bit-equal to the source model's "
             f"({sum(t.numel() for t in state.values()) / 1e9:.3f} B elements)")

    results = {}
    for fused in (False, True):
        want_tokens, want_logits = _hf_serve(torch, source, fused)
        if not fused:
            kernels.reset_launch_counts()
        tokens, logits = _hf_serve(torch, model, fused)
        if not fused:
            counts = {k: v for k, v in kernels.launch_counts().items() if k in path_kernels}
        results[fused] = tokens
        what = "fused" if fused else "stepwise"
        if not np.array_equal(tokens, want_tokens):
            raise AssertionError(f"{tag}: {what} tokens differ from the source model's: {tokens.tolist()} vs "
                                 f"{want_tokens.tolist()}")
        if len(logits) != len(want_logits) or not all(_bit_equal(torch, a, b) for a, b in zip(logits, want_logits)):
            raise AssertionError(f"{tag}: {what} logits differ from the source model's")
        if not all(bool(torch.isfinite(x).all()) for x in logits):
            raise AssertionError(f"{tag}: non-finite logits")
    if not np.array_equal(results[False], results[True]):
        raise AssertionError(f"{tag}: the fused window's tokens differ from the stepwise serve's")
    if tokens.shape != (len(HF_PROMPTS), HF_STEPS):
        raise AssertionError(f"{tag}: generated ids shape {tokens.shape}")
    log(tag, f"launches of the loaded model's stepwise serve: {counts}")
    if min(counts.values()) <= 0 or set(counts) != set(path_kernels):
        raise AssertionError(f"{tag}: a kernel of the path never launched: {counts}")
    if typewriter_check:
        kernels.reset_launch_counts()
        typed, _ = _hf_serve(torch, model, False, typewriter=True)
        typed_counts = {k: v for k, v in kernels.launch_counts().items() if k in path_kernels}
        if typed_counts != counts or not np.array_equal(typed, results[False]):
            raise AssertionError(f"{tag}: the typewriter changed the launches {typed_counts} vs {counts}")
        log(tag, "with the typewriter on: the same tokens and the same launches")
    log(tag, f"{len(HF_PROMPTS)} prompts of {[len(p.encode()) for p in HF_PROMPTS]} tokens, {HF_STEPS} greedy "
             f"tokens through MojoGenerator.__call__ stepwise and fused: tokens and every step's logits bit-identical "
             f"to the source model's serve; tokens of the 1-token prompt {results[False][-1].tolist()}")
    del model
    return counts


def _deterministic_serve(path: str) -> None:
    """Phase 21's child, run with MOJO_DETERMINISTIC=1: the checkpoint at
    ``path`` loaded on the card and served twice stepwise (graphs) and once
    fused, greedy; then twice stepwise and twice fused with top-k sampling
    (HF_TOP_K, the generator's seed 0); prints one JSON line.
    Fails unless each pair of serves agrees bit for bit (tokens and every
    step's logits) and the greedy fused tokens equal the stepwise ones."""
    import torch

    import mojo_opset_tpu_torch  # noqa: F401  (applies MOJO_DETERMINISTIC=1)
    from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_qwen3
    from mojo_opset_tpu_torch.utils.platform import is_deterministic

    if not (is_deterministic() and torch.are_deterministic_algorithms_enabled()):
        raise AssertionError("deterministic mode is not on")
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("deterministic mode left cuBLAS's workspace or TF32 as they were")
    t0 = time.perf_counter()
    model = apply_mojo_to_qwen3(path, device="cuda", strict=True)
    load_s = time.perf_counter() - t0
    if not model.config.runtime_config.is_deterministic:
        raise AssertionError("MojoRunTimeConfig.is_deterministic does not follow MOJO_DETERMINISTIC=1")
    runs, times = [], []
    for fused in (False, False, True):
        t0 = time.perf_counter()
        runs.append(_hf_serve(torch, model, fused))
        times.append(time.perf_counter() - t0)
    (a, la), (b, lb), (c, _) = runs
    same_logits = len(la) == len(lb) and all(_bit_equal(torch, x, y) for x, y in zip(la, lb))
    if not (np.array_equal(a, b) and same_logits and np.array_equal(a, c)):
        raise AssertionError(f"deterministic serves differ: tokens equal {np.array_equal(a, b)}, logits equal "
                             f"{same_logits}, fused tokens equal {np.array_equal(a, c)}")
    if not all(bool(torch.isfinite(x).all()) for x in la):
        raise AssertionError("deterministic serve: non-finite logits")
    sampled = {}
    for fused in (False, True):
        (s1, l1), (s2, l2) = (_hf_serve(torch, model, fused, top_k=HF_TOP_K) for _ in range(2))
        if not (np.array_equal(s1, s2) and all(_bit_equal(torch, x, y) for x, y in zip(l1, l2))):
            raise AssertionError(f"deterministic top-k serves differ ({'fused' if fused else 'stepwise'})")
        sampled["fused" if fused else "stepwise"] = s1.tolist()
    print(json.dumps({"tokens": a.tolist(), "load_s": load_s, "serve_s": times, "top_k": sampled}), flush=True)


def phase_hf_checkpoint(torch, card: str) -> dict:
    """Phase 21: HF checkpoints on disk into the port's models. Qwen3-4B's
    published config with seeded bf16 weights, written in two shards by
    ``_safetensors_file`` and loaded by ``apply_mojo_to_qwen3(strict=True)``;
    Qwen3-30B-A3B cut to HF_MOE_LAYERS layers in HF's per-expert layout,
    loaded by ``apply_mojo_to_qwen3_moe(strict=True)`` (``_hf_round_trip``
    each); a child under MOJO_DETERMINISTIC=1 serving the Qwen3-4B
    checkpoint twice (``_deterministic_serve``). Returns the launches by path."""
    import shutil
    import tempfile

    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3ForCausalLM, Qwen3MoeForCausalLM
    from mojo_opset_tpu_torch.utils.hf import qwen3_config_from_hf, qwen3_moe_config_from_hf
    from mojo_opset_tpu_torch.utils.patching import apply_mojo_to_qwen3, apply_mojo_to_qwen3_moe

    here = os.path.dirname(os.path.abspath(__file__))
    counts = {}
    gc.collect()
    torch.cuda.empty_cache()
    path = tempfile.mkdtemp(prefix=".hf_checkpoint_", dir=here)
    try:
        source = Qwen3ForCausalLM(qwen3_config_from_hf(HF_QWEN3_4B), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(0))
        tensors = dict(source.state_dict())
        if "lm_head.weight" in tensors or source.lm_head is not None:
            raise AssertionError("hf checkpoint: Qwen3-4B is tied; its checkpoint has no lm_head.weight")
        counts["hf_qwen3_4b"] = _hf_round_trip(torch, card, "hf qwen3-4b", source, path, tensors, HF_QWEN3_4B,
                                               apply_mojo_to_qwen3, BF16_PATH_KERNELS, typewriter_check=True)
        t0 = time.perf_counter()
        child = subprocess.run([sys.executable, "-c", f"import chip_smoke as s; s._deterministic_serve({path!r})"],
                               cwd=here, env=dict(os.environ, MOJO_DETERMINISTIC="1"), capture_output=True,
                               text=True, timeout=HF_CHILD_TIMEOUT_S)
        if child.returncode != 0:
            raise AssertionError(f"hf deterministic: the child failed ({child.returncode}): "
                                 f"{(child.stdout + child.stderr)[-4000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        plain_tokens, _ = _hf_serve(torch, source, False)
        same = np.array_equal(np.asarray(got["tokens"]), plain_tokens)
        log("hf deterministic", f"{card}: MOJO_DETERMINISTIC=1 in a child: loaded in {got['load_s']:.1f} s, two "
                                f"stepwise serves bit-identical (tokens and every step's logits), the fused "
                                f"window's tokens the same; serves {[round(s, 2) for s in got['serve_s']]} s; tokens "
                                f"{'==' if same else '!='} the default mode's; top-{HF_TOP_K} sampling from seed 0 "
                                f"twice stepwise and twice fused, each pair bit-identical; "
                                f"{time.perf_counter() - t0:.1f} s with the child's start")
        del source, tensors
        shutil.rmtree(path)
        os.mkdir(path)
        gc.collect()
        torch.cuda.empty_cache()

        hf_cfg = dict(HF_QWEN3_30B_A3B, num_hidden_layers=HF_MOE_LAYERS)
        source = Qwen3MoeForCausalLM(qwen3_moe_config_from_hf(hf_cfg), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(0))
        with torch.no_grad():  # HF stores the router in bf16: make the source's fp32 router bf16-exact
            for layer in source.layers:
                gate = layer.mlp.gating.gate_weight
                gate.copy_(gate.to(torch.bfloat16).float())
        counts["hf_qwen3_30b_a3b"] = _hf_round_trip(torch, card, "hf qwen3-30b-a3b", source, path,
                                                    _hf_moe_tensors(torch, source), hf_cfg, apply_mojo_to_qwen3_moe,
                                                    MOE_PATH_KERNELS)
        del source
    finally:
        shutil.rmtree(path, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 22: the perf harness and protocols

HARNESS_ITERS = 2  # run_perf's chains start at 2 calls (its CLI's default is 16) and double while the fixed cost shows
HARNESS_PREFILL = (512, 2048, 8192)
HARNESS_DECODE_BS = (1, 8, 24)
HARNESS_NEW_TOKENS = 32
# Qwen3-4B's geometry with positions for the 8192-token prefill and a window after it
HARNESS_QWEN3_4B = dict(QWEN3_4B, max_position_embeddings=8224)
HARNESS_INT8_STEPS = 1e-3  # the share of int8 values that may sit one step apart (a tie rounded the other way)
# specs whose cuda-vs-ref check runs on RoPE tables (equal halves) in place of the descriptor's random ones: kernel
# M's backward is its forward with -sin, the transpose of a rotation only (the TPU kernel's, rope.py:153-159)
HARNESS_ROPE_TABLES = ("ApplyRoPEFunction",)


def _harness_close(torch, where: str, got, want) -> float:
    """``got`` (the cuda tier) against ``want`` (the golden) on the same inputs: float tensors to their dtype's
    ladder (``utils/acc.py``), int8 values within one step on at most HARNESS_INT8_STEPS of them, the rest
    equal; returns the largest float difference."""
    from mojo_opset_tpu_torch.utils.acc import check_tol_diff, tols_for

    if isinstance(want, (tuple, list)):
        if not isinstance(got, (tuple, list)) or len(got) != len(want):
            raise AssertionError(f"harness {where}: output structure differs from the golden's")
        return max([_harness_close(torch, f"{where}[{i}]", g, w) for i, (g, w) in enumerate(zip(got, want))],
                   default=0.0)
    if not isinstance(want, torch.Tensor):
        if got != want:
            raise AssertionError(f"harness {where}: {got!r} != golden {want!r}")
        return 0.0
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"harness {where}: {tuple(got.shape)} {got.dtype} vs golden {tuple(want.shape)} "
                             f"{want.dtype}")
    if not want.is_floating_point():
        diff = (got.long() - want.long()).abs()
        moved = int((diff != 0).sum())
        if int(diff.max()) > 1 or moved > HARNESS_INT8_STEPS * want.numel():
            raise AssertionError(f"harness {where}: {moved} integers differ, by up to {int(diff.max())}")
        return 0.0
    try:
        check_tol_diff(got, want, **tols_for(want.dtype))
    except AssertionError as err:
        raise AssertionError(f"harness {where}: {err}") from None
    return float((got.float() - want.float()).abs().max())


def _harness_sweep(torch, card: str) -> tuple:
    """(a) ``run_perf``'s smoke preset in process over every spec, ref and cuda tiers, on the card: a case that
    raises fails the phase (``strict``), every time > 0; then each cuda op's output against the golden's on the same
    inputs and weights. Returns the sweep's launches and records."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.benchmark import run_perf
    from mojo_opset_tpu_torch.benchmark.api import discover_perf_specs

    specs = discover_perf_specs()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    records = run_perf.run_sweep(None, ("ref", "cuda"), "smoke", HARNESS_ITERS, device="cuda", strict=True)
    counts = kernels.launch_counts()
    log("harness", f"{card}: run_perf smoke preset, {len(specs)} specs, {len(records)} records in "
                   f"{time.perf_counter() - t0:.1f} s")
    for r in records:
        log("harness", " | ".join(f"{k}={r[k]}" for k in ("op", "case", "provider", "us", "timing", "tflops", "gbps",
                                                           "route") if k in r))
    bad = [r for r in records if not r["us"] > 0]
    if bad:
        raise AssertionError(f"harness: times not above 0: {bad}")
    for name, spec in specs.items():
        if spec.profiling.kernels is None:
            continue
        for r in records:
            if r["op"] == name and r["provider"] == "cuda" and r["timing"] != "profiler":
                log("harness", f"{name}/{r['case']}: the profiler's trace held no whole set of kernels matching "
                               f"{spec.profiling.kernels} (the timing log says which); the chain's {r['timing']} "
                               f"time stands")
    routes = {f"{r['op']}/{r['case']}": r["route"] for r in records if r["provider"] == "cuda"}
    log("harness", f"cuda routes: {routes}")
    # every smoke case's form is one the JAX package's Pallas tier runs on a kernel, or one its op has no Pallas
    # form for: a golden route here would time plain PyTorch under the cuda tier's name
    golden = sorted(case for case, route in routes.items() if route == "golden")
    if golden:
        raise AssertionError(f"harness: cuda records on the golden route: {golden}")
    log("harness", f"timers: { {t: sum(r['timing'] == t for r in records) for t in ('graph', 'events', 'profiler')} }")
    gc.collect()
    torch.cuda.empty_cache()

    worst = {}
    for spec, case in run_perf.selected_cases(None, "smoke"):
        if "cuda" not in spec.target.get_registered_backends():
            continue
        ref = run_perf.prepare_case(spec, "ref", case, "cuda")
        cuda = run_perf.prepare_case(spec, "cuda", case, "cuda")
        cuda.op.load_state_dict(ref.op.state_dict())  # the weights the op draws for itself
        if spec.name in HARNESS_ROPE_TABLES:
            for prepared in (ref, cuda):
                for table in (prepared.tensors["cos"], prepared.tensors["sin"]):
                    half = table.shape[-1] // 2
                    table[..., half:] = table[..., :half]
        err = _harness_close(torch, f"{spec.name}/{case.id}", cuda.call(), ref.call())
        worst[spec.name] = max(worst.get(spec.name, 0.0), err)
        del ref, cuda
    gc.collect()
    torch.cuda.empty_cache()
    log("harness", f"cuda against ref on the same inputs, each dtype's ladder; largest |diff| by op: "
                   f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} }")
    return counts, records


def _harness_prefill_grid(torch, card: str) -> None:
    """Kernel D on the PagedPrefillGQA smoke case two ways, each chain replayed from a CUDA graph: ``max_q_len``
    omitted (the op bounds D's grid by the packed token count, read from shapes) and given (the longest segment,
    read back here once); the outputs equal."""
    from mojo_opset_tpu_torch.benchmark import run_perf
    from mojo_opset_tpu_torch.benchmark.timing import timed_us

    (spec, case), = run_perf.selected_cases(["PagedPrefillGQA"], "smoke")
    prepared = run_perf.prepare_case(spec, "cuda", case, "cuda")
    cu = prepared.tensors["cu_q_lens"]
    longest = int((cu[1:] - cu[:-1]).max())
    op, args = prepared.op, prepared.args

    def given(*a):
        return op(*a, max_q_len=longest)

    with torch.no_grad():
        if not torch.equal(op(*args), given(*args)):
            raise AssertionError("harness: D's output depends on its grid bound")
        times = {name: timed_us(fn, *args, iters=HARNESS_ITERS) for name, fn in (("packed", op), ("given", given))}
    log("harness", f"{card}: D on PagedPrefillGQA/{case.id}: grid bound {prepared.tensors['query'].shape[0]} "
                   f"(packed, the default) {times['packed'][0]:.3f} us ({times['packed'][1]}), {longest} (given) "
                   f"{times['given'][0]:.3f} us ({times['given'][1]})")


def _harness_generator(torch, card: str) -> dict:
    """(b) ``PerfMojoGenerator`` at Qwen3-4B's geometry (random bf16 weights from seed 0, block 64): prefill at
    HARNESS_PREFILL, decode at HARNESS_DECODE_BS at its ctx 4000, HARNESS_NEW_TOKENS new tokens, fused windows;
    every rate above 0, no golden route, A-D launched. Returns the launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.runtime import GreedySampler, PagedAttentionGenerationModel, PerfMojoGenerator

    model = Qwen3ForCausalLM(Qwen3Config(**HARNESS_QWEN3_4B, dtype=torch.bfloat16), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(0))
    gen = PerfMojoGenerator(PagedAttentionGenerationModel(model, block_size=64), None, GreedySampler(),
                            max_new_tokens=HARNESS_NEW_TOKENS)
    golden = golden_counts()
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    out = gen(prefill_seqlens=HARNESS_PREFILL, decode_batch_sizes=HARNESS_DECODE_BS, fused=True)
    counts = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    if golden_counts() != golden:
        raise AssertionError("harness generator: a golden route was taken")
    missing = [k for k in BF16_PATH_KERNELS if not counts[k]]
    if missing:
        raise AssertionError(f"harness generator: kernels {missing} never launched")
    for r in out["prefill"]:
        log("harness", f"{card}: PerfMojoGenerator prefill {r['in_tok']} tokens bs 1: {r['prefill_ms']:.3f} ms")
    for r in out["decode"]:
        log("harness", f"{card}: PerfMojoGenerator decode bs {r['batch_size']} ctx {gen.DECODE_CONTEXT}: "
                       f"{r['decode_steps']} steps {r['decode_avg_ms']:.3f} ms/step {r['throughput']:.1f} tok/s "
                       f"(prefill {r['prefill_ms']:.1f} ms)")
    for r in out["fused_decode"]:
        log("harness", f"{card}: PerfMojoGenerator fused window bs {r['batch_size']}: {r['decode_steps']} steps "
                       f"{r['decode_avg_ms']:.3f} ms/step {r['throughput']:.1f} tok/s ({r['timer']})")
    rates = [r["prefill_ms"] for r in out["prefill"]] + [r["throughput"] for r in out["decode"] + out["fused_decode"]]
    if not (len(rates) == 9 and all(v > 0 for v in rates)):
        raise AssertionError(f"harness generator: rates not above 0: {out}")
    log("harness", f"PerfMojoGenerator sweep {seconds:.1f} s; launches {dict((k, counts[k]) for k in BF16_PATH_KERNELS)}")
    _harness_prefill_trace(torch, gen, card)
    del gen, model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _harness_prefill_trace(torch, gen, card: str) -> dict:
    """What a recorded HARNESS_PREFILL[0]-token prefill's span holds: the prefill's model call timed with no sync
    (the host's enqueue) against the same call synchronized (best of 3 each), then one recorded prefill traced by
    the port's profiler hook (``CUDAProfilerHook`` from before the prefill to the end of its one-step decode): the
    device's busy time (the union of its kernels, copies and sets), their count, and the host's costliest CUDA
    runtime calls and ops. Returns the readings."""
    import tempfile

    from mojo_opset_tpu_torch.utils.profiler import CUDAProfilerHook

    ids, lens = gen._random_prompts(1, HARNESS_PREFILL[0])
    enqueue, done = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, session = gen.model(ids, context_input_len=lens)
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        done.append(time.perf_counter() - t0)
        del logits, session
    with tempfile.TemporaryDirectory(prefix="mojo_prefill_trace_") as tmp:
        hook = CUDAProfilerHook(log_dir=tmp, wait=0, active=1)
        gen._hooks.insert(0, hook)  # the profiler starts before PerfHook's stamp opens the span
        try:
            gen.generate_from_ids(ids, lens, max_decode_steps=1, ignore_eos=True, silent=True)
        finally:
            gen._hooks.remove(hook)
        with open(hook.traces[-1]) as f:
            events = json.load(f)["traceEvents"]
    span_ms = gen.perf_hook.records[-1]["prefill_ms"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -math.inf
    for a, b in device:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    runtime = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "dur" in e:
            n, t = runtime.get(e["name"], (0, 0.0))
            runtime[e["name"]] = (n + 1, t + e["dur"])
    top_runtime = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:5]
    top_ops = sorted((a for a in hook.profile.key_averages() if a.self_cpu_time_total > 0),
                     key=lambda a: -a.self_cpu_time_total)[:8]
    out = {"enqueue_ms": 1e3 * min(enqueue), "synchronized_ms": 1e3 * min(done), "traced_span_ms": span_ms,
           "device_busy_ms": busy / 1e3, "device_launches": len(device)}
    log("harness", f"{card}: prefill {HARNESS_PREFILL[0]} tokens, model call untraced: enqueue "
                   f"{out['enqueue_ms']:.3f} ms, synchronized {out['synchronized_ms']:.3f} ms (best of 3); traced "
                   f"PerfHook span {span_ms:.3f} ms, device busy {out['device_busy_ms']:.3f} ms over "
                   f"{len(device)} kernels, copies and sets")
    log("harness", "prefill trace, CUDA runtime calls by host time (calls, ms): "
                   + "; ".join(f"{name} {n} {t / 1e3:.3f}" for name, (n, t) in top_runtime))
    log("harness", "prefill trace, host ops by self time (calls, ms): "
                   + "; ".join(f"{a.key} {a.count} {a.self_cpu_time_total / 1e3:.3f}" for a in top_ops))
    if not (busy > 0 and len(device) > 0):
        raise AssertionError(f"harness prefill trace: no device work in the trace: {out}")
    return out


def _harness_dit(torch, card: str) -> dict:
    """(c) ``run_dit_perf`` at the JAX package's defaults (dim 2048, 32 layers, bf16, ``PerfDiTRunner.SIZES``, 4
    steps): ms a step above 0 and finite TFLOP/s. Returns the launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.benchmark.dit_protocol import run_dit_perf

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    records = run_dit_perf(dim=2048, layers=32, steps=4, dtype=torch.bfloat16)
    counts = kernels.launch_counts()
    for r in records:
        log("harness", f"{card}: run_dit_perf latent {r['latent']} {r['tokens']} tokens: {r['denoise_ms']:.3f} "
                       f"ms/step {r['tflops']:.1f} TFLOP/s ({r['timer']})")
    if len(records) != 3 or not all(r["denoise_ms"] > 0 and math.isfinite(r["tflops"]) for r in records):
        raise AssertionError(f"harness dit: {records}")
    log("harness", f"run_dit_perf {time.perf_counter() - t0:.1f} s; launches "
                   f"{ {k: v for k, v in counts.items() if v} }")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _harness_launch(torch, card: str) -> None:
    """(d) ``launch``: the mesh sweep on a one-rank NCCL group at the full shapes (a time at the timer's 1e-3 us
    floor is a marginal lost in noise, not a measurement), then the per-device fan-out on the one card with
    ``--ops RMSNorm`` (each a child process: its launches are its own)."""
    from mojo_opset_tpu_torch.benchmark import launch

    t0 = time.perf_counter()
    mesh = launch.main(["--mode", "mesh", "--num-devices", "1"])
    if [r["op"] for r in mesh] != ["GemmAllReduce", "AllGatherGemm", "GemmReduceScatter", "GemmAll2All"] or \
            not all(r["provider"] == "nccl" and r["us"] > 1e-3 and r["timing"] == "events" for r in mesh):
        raise AssertionError(f"harness mesh: {mesh}")
    for r in mesh:
        log("harness", f"{card}: launch mesh {r['op']} {r['case']} ({r['provider']}): {r['us']} us "
                       f"{r['tflops']} TFLOP/s")
    fan = launch.main(["--mode", "device", "--ops", "RMSNorm", "--iters", str(HARNESS_ITERS)])
    if len(fan) != 6 or not all(r["device"] == 0 and r["us"] > 0 for r in fan):
        raise AssertionError(f"harness fan-out: {fan}")
    for r in fan:
        log("harness", f"{card}: launch device 0 {r['op']}/{r['case']}/{r['provider']}: {r['us']} us ({r['timing']}"
                       f"{', ' + r['route'] if 'route' in r else ''})")
    log("harness", f"launch {time.perf_counter() - t0:.1f} s with its children")


def phase_harness(torch, card: str) -> dict:
    """Phase 22: the per-op perf harness and the perf protocols (see the module docstring). Returns the in-process
    launches by path."""
    gc.collect()
    torch.cuda.empty_cache()
    counts = {}
    counts["harness_sweep"], _ = _harness_sweep(torch, card)
    _harness_prefill_grid(torch, card)
    counts["harness_generator"] = _harness_generator(torch, card)
    counts["harness_dit"] = _harness_dit(torch, card)
    _harness_launch(torch, card)
    return counts


# ---------------------------------------------------------------- phase 23: dp x tp training and the rest of the
# distributed layer
TRAIN_TP_LAYERS = 4  # (a) the one-rank NCCL step: Qwen3-4B widths, depth 36 -> 4, B TRAIN_BATCH x S TRAIN_SEQ
TRAIN_TP_TURNS = 4  # sharded and unsharded steps in turns, of each; the first keeps its gradients for the checks
TRAIN_DP_LAYERS = 2  # (b) dp 2 x tp 2 in four gloo processes on the one card: depth 36 -> 2
TRAIN_DP_SEQ = 1024  # a dp rank's batch, TRAIN_BATCH x TRAIN_DP_SEQ; the unsharded step takes both ranks' rows
TRAIN_DP_TIMEOUT_S = 480
# (b) against the unsharded step on the whole batch: the bf16 row-parallel sums, the dp mean of two bf16 gradients
# and the loss's tp combine all run in another order than the unsharded step's; phase 10's bounds hold (the probe,
# on an H100 80GB HBM3 at 700 W: loss gap 1.89e-6, the lowest cosine 0.999962, a q_norm weight's)
TRAIN_DP_LOSS_REL_BOUND = TRAIN_LOSS_REL_BOUND
TRAIN_DP_COSINE_BOUND = TRAIN_GRAD_COSINE_BOUND
SPEC_NCCL_LENS = (96, 33, 9, 2)  # prompts of the one-rank speculative run on SMALL (its 256 positions)
SPEC_NCCL_STEPS = 24
RING_SHAPE = (TRAIN_TOKENS, 2560, 9728)  # rows, K, N of the one-rank ring ops: the train step's up projection


def _train_tp1(torch, card, mesh) -> dict:
    """(a) The sharded train step on the one-rank NCCL groups (dp 1 x tp 1) against the unsharded step on the same
    weights (both from seed 0) and batch, each with fused AdamW at optax.adamw(1e-4)'s settings, in turns: the
    loss and every gradient of the first turn, and every parameter after the last, bit for bit or the gap stated;
    the sharded step's launches exactly ``_train_launches``; step ms in turns; the NCCL kernels of a profiled step.
    Returns the sharded step's launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.parallel.training import ADAMW, finish_gradients, train_loss, valid_tokens

    model, ids = _train_model(torch, TRAIN_TP_LAYERS)
    sharded, _ = _train_model(torch, TRAIN_TP_LAYERS)
    sharded = shard_model(sharded, mesh, qwen3_tp_rules("tp"))
    vocab = sharded.lm_head_vocab
    if vocab is None or vocab.group is None or vocab.vocab_size != model.qwen3_config.vocab_size:
        raise AssertionError(f"train tp 1: the sharded LM head is not vocab-parallel: {vocab}")
    loss_fn, _ = _loss_ops()
    inputs, targets = ids[:, :-1], ids[:, 1:]
    models = {"unsharded": model, "sharded": sharded}
    opts = {k: torch.optim.AdamW([p for p in m.parameters() if p.requires_grad], fused=True, **ADAMW)
            for k, m in models.items()}

    def step(name, keep=False):
        m = models[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "sharded":
            loss = train_loss(m, inputs, targets, loss_fn)
            loss.backward()
            finish_gradients(m, mesh.group("dp"), valid_tokens(targets))
        else:
            hidden = m.train_forward(inputs)
            loss = loss_fn(hidden.reshape(-1, hidden.shape[-1]), m.lm_head_weight, targets.reshape(-1))
            loss.backward()
        grads = {n: p.grad.clone() for n, p in m.named_parameters()} if keep else None
        opts[name].step()
        opts[name].zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        return loss.detach().float(), (time.perf_counter() - t0) * 1e3, grads

    golden = golden_counts()
    loss_u, _, grads_u = step("unsharded", keep=True)
    kernels.reset_launch_counts()
    loss_s, _, grads_s = step("sharded", keep=True)
    counts = kernels.launch_counts()
    want = _train_launches(TRAIN_TP_LAYERS)
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"train tp 1: the sharded step launched {counts}, want {want}")
    if golden_counts() != golden:
        raise AssertionError("train tp 1: a golden route was taken")
    if set(grads_u) != set(grads_s):
        raise AssertionError(f"train tp 1: other parameters: {sorted(set(grads_u) ^ set(grads_s))}")
    same = [n for n in grads_u if torch.equal(grads_u[n], grads_s[n])]
    cos = sorted(((n, _cosine(torch, grads_s[n], grads_u[n])) for n in grads_u), key=lambda kv: kv[1])
    loss_gap = abs(loss_s.item() - loss_u.item()) / abs(loss_u.item())
    del grads_u, grads_s
    times = {"unsharded": [], "sharded": []}
    for _ in range(TRAIN_TP_TURNS - 1):
        for name in times:
            times[name].append(step(name)[1])
    busy, nccl = _nccl_profile(torch, lambda: step("sharded"))
    plain_busy, _ = _nccl_profile(torch, lambda: step("unsharded"))
    params = {n: p for n, p in model.named_parameters()}
    after = [n for n, p in sharded.named_parameters() if torch.equal(p, params[n])]
    medians = {k: float(np.median(v)) for k, v in times.items()}
    log("train parallel", f"{card}: (a) one-rank NCCL groups (dp 1 x tp 1), {TRAIN_TP_LAYERS} layers at Qwen3-4B "
                          f"width, B {TRAIN_BATCH} x S {TRAIN_SEQ}: loss {loss_s.item():.9g} sharded vs "
                          f"{loss_u.item():.9g} unsharded (bit for bit: {bool(torch.equal(loss_s, loss_u))}, "
                          f"relative gap {loss_gap:.3g}); "
                          f"gradients bit for bit {len(same)} of {len(cos)}, lowest cosine "
                          f"{[(n, round(c, 9)) for n, c in cos[:2]]}; parameters after {TRAIN_TP_TURNS + 1} AdamW "
                          f"steps bit for bit {len(after)} of {len(params)}; launches {dict(counts)}")
    log("train parallel", f"{card}: (a) step ms in turns (fused AdamW included): sharded {times['sharded']}, unsharded "
                          f"{times['unsharded']}; medians {medians['sharded']:.3f} vs {medians['unsharded']:.3f}; "
                          f"device busy of a profiled step {busy:.3f} vs {plain_busy:.3f} ms; NCCL kernels of a "
                          f"sharded step {nccl} (a one-rank all_reduce in place launches nothing)")
    if not loss_gap <= TRAIN_LOSS_REL_BOUND or cos[0][1] < TRAIN_GRAD_COSINE_BOUND:
        raise AssertionError(f"train tp 1: the sharded step parts from the unsharded: loss gap {loss_gap}, {cos[:3]}")
    del model, sharded, opts, params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: counts[k] for k in want}


def _speculative_nccl(torch, card, mesh) -> dict:
    """(a) Greedy speculative decoding on the one-rank NCCL group: the SMALL fp32 Qwen3 target sharded (fp32, as
    phase 4's speculative runs: in bf16 the verify's prefill and the decode step part at near-ties) and its w8a8
    draft (``quantize_qwen3`` of the whole model, then sharded), draft rounds and verifies on CUDA graphs (the NCCL
    collectives captured; the second call replays), against the unsharded model's vanilla greedy stream, bit for
    bit. Returns the replayed call's launches."""
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM, quantize_qwen3
    from mojo_opset_tpu_torch.parallel import qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.runtime import SpeculativeDecoder

    config = Qwen3Config(**SMALL, dtype=torch.float32)

    def draw():
        return Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))

    model = draw()
    target = shard_model(draw(), mesh, qwen3_tp_rules("tp"))
    draft = shard_model(quantize_qwen3(draw()), mesh, qwen3_tp_rules("tp"))
    ids, lens = _prompts(config.vocab_size, SPEC_NCCL_LENS)
    want = _standalone_greedy(model, ids, lens, SPEC_NCCL_STEPS)
    spec = SpeculativeDecoder(target, draft, k=TP2_SPEC_K, mode="greedy", block_size=16)
    if not spec.device_graph:
        raise AssertionError("speculative decoding over NCCL groups did not take graphs")
    spec.generate(ids, lens, max_new_tokens=SPEC_NCCL_STEPS)  # warm-up and capture
    kernels.reset_launch_counts()
    got = spec.generate(ids, lens, max_new_tokens=SPEC_NCCL_STEPS)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if not all(r.graph is not None for pool in (spec._draft_pool, spec._verify_pool) for r in pool.runners()):
        raise AssertionError("speculative decoding over NCCL groups: a round never replayed from its graph")
    if not np.array_equal(got, want):
        raise AssertionError(f"speculative decoding over NCCL groups: {got.tolist()} differ from the unsharded "
                             f"greedy {want.tolist()}")
    log("train parallel", f"{card}: (a) greedy speculative decoding on the one-rank NCCL group (SMALL fp32 target, its "
                          f"w8a8 draft, both sharded, k {TP2_SPEC_K}): draft rounds and verifies replayed from graphs, "
                          f"{SPEC_NCCL_STEPS} tokens x {len(lens)} == the unsharded greedy stream in "
                          f"{spec.last_rounds} rounds; launches {counts}")
    return counts


def _ring_one_rank(torch, card, mesh) -> None:
    """(a) The ring AllGatherGemm and GemmReduceScatter (the cuda tier's) on the one-rank NCCL group: a ring of one
    is the plain GEMM, as in JAX (:32, :66), bit for bit with the golden's; timed beside it."""
    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.core.operators.compute_with_comm import _gemm

    rows, K, N = RING_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(rows, K, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(N, K, device="cuda", generator=gen).to(torch.bfloat16)
    want = _gemm(x, w, None, False)
    times = {}
    for op in (tm.MojoAllGatherGemm(w, group=mesh.group("tp")), tm.MojoGemmReduceScatter(w, group=mesh.group("tp"))):
        name = type(op).__name__
        if not name.startswith("Cuda"):
            raise AssertionError(f"ring ops: {name} is not the cuda tier's")
        with torch.no_grad():
            if not torch.equal(op(x), want):
                raise AssertionError(f"ring ops: {name} on one rank differs from the plain GEMM")
            times[name] = cuda_ms(torch, lambda: op(x), iters=5)
    plain = cuda_ms(torch, lambda: _gemm(x, w, None, False), iters=5)
    log("train parallel", f"{card}: (a) the ring ops on the one-rank NCCL group at ({rows}, {K}) x ({N}, {K}) bf16: a "
                          f"ring of one is the plain GEMM (JAX :32, :66), bit for bit; ms {times}, plain {plain:.3f}. "
                          f"NCCL refuses two ranks on one card: the ring's arithmetic is checked on the CPU only "
                          f"(tests/test_torch_parallel_train.py, gloo, world 2 and 4)")


def _train_dp_worker(rank: int, workdir: str) -> None:
    """One of (b)'s four ranks on the one card (gloo carries CUDA tensors): the unsharded step on the whole batch,
    its gradients cut as this rank holds its parameters (``shard_model`` of a model whose weights are those
    gradients, on a groupless view of the rank's coordinates), then the sharded step on this dp rank's rows; writes
    the losses, each parameter's gradient cosine, the launches and the ring ops' refusal over gloo."""
    import torch
    import torch.distributed as dist

    import mojo_opset_tpu_torch as tm
    from mojo_opset_tpu_torch.backends.cuda import kernels
    from mojo_opset_tpu_torch.modeling.qwen3 import Qwen3Config, Qwen3ForCausalLM
    from mojo_opset_tpu_torch.parallel import MojoMesh, build_mesh, init_distributed, qwen3_tp_rules, shard_model
    from mojo_opset_tpu_torch.parallel.training import finish_gradients, train_loss, valid_tokens
    from mojo_opset_tpu_torch.runtime import comm_context

    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed(rank, 4, f"file://{workdir}/rendezvous", device="cuda", backend="gloo")
    mesh = build_mesh((2, 2), ("dp", "tp"))
    config = Qwen3Config(**dict(QWEN3_4B, num_hidden_layers=TRAIN_DP_LAYERS), dtype=torch.bfloat16)

    def draw():
        m = Qwen3ForCausalLM(config, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        return m.requires_grad_(True)

    ids = torch.randint(1, config.vocab_size, (2 * TRAIN_BATCH, TRAIN_DP_SEQ + 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    loss_fn = tm.MojoFusedLinearCrossEntropyFunction()
    ref = draw()
    hidden = ref.train_forward(ids[:, :-1])
    ref_loss = loss_fn(hidden.reshape(-1, hidden.shape[-1]), ref.lm_head_weight, ids[:, 1:].reshape(-1))
    ref_loss.backward()
    del hidden
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.grad)
    ref.zero_grad(set_to_none=True)
    want = dict(shard_model(ref, MojoMesh.local(mesh.shape, mesh.coords), qwen3_tp_rules("tp")).named_parameters())
    model = shard_model(draw(), mesh, qwen3_tp_rules("tp"))
    torch.cuda.empty_cache()
    d = mesh.rank("dp")
    rows = ids[d * TRAIN_BATCH:(d + 1) * TRAIN_BATCH]
    golden = golden_counts()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = train_loss(model, rows[:, :-1], rows[:, 1:], loss_fn)
    loss.backward()
    weight = valid_tokens(rows[:, 1:])
    finish_gradients(model, mesh.group("dp"), weight)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    golden_moved = golden_counts() != golden
    global_loss = comm_context.mean_over_group(loss.detach().float(), mesh.group("dp"), weight)
    cos = {n: _cosine(torch, p.grad, want[n]) for n, p in model.named_parameters()}
    try:
        x = torch.ones(8, 16, device="cuda", dtype=torch.bfloat16)
        tm.MojoAllGatherGemm(torch.ones(4, 16, device="cuda", dtype=torch.bfloat16), group=mesh.group("tp"))(x)
        ring = ""
    except RuntimeError as err:
        ring = str(err)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), loss=np.asarray(global_loss.item()),
             ref_loss=np.asarray(ref_loss.item()), cos_names=np.asarray(list(cos)),
             cos=np.asarray(list(cos.values())), counts=json.dumps(counts), golden_moved=np.asarray(golden_moved),
             ring=np.asarray(ring), step_ms=np.asarray(step_ms), vocab=np.asarray(model.lm_head_vocab[1:]),
             peak_gib=np.asarray(torch.cuda.max_memory_allocated() / 2**30))
    dist.barrier()
    dist.destroy_process_group()


def _train_dp2_tp2(torch, card) -> dict:
    """(b) dp 2 x tp 2 in four processes on the one card over gloo (NCCL refuses two ranks on one device): Qwen3-4B
    widths cut to TRAIN_DP_LAYERS layers, B TRAIN_BATCH x S TRAIN_DP_SEQ a dp rank, against the unsharded step on
    the whole batch: the dp-mean loss within TRAIN_DP_LOSS_REL_BOUND, every parameter's gradient (after
    ``finish_gradients``) at a cosine of at least TRAIN_DP_COSINE_BOUND against its shard of the unsharded one; J,
    K, L, M, N and A launched on every rank, no golden route; the ring ops refuse CUDA tensors over gloo. Returns
    rank 0's launches."""
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="train_dp_")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", f"import chip_smoke as s; s._train_dp_worker({r}, {workdir!r})"],
                              cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=TRAIN_DP_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, o[-3000:]) for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        raise AssertionError(f"train dp 2 x tp 2: rank processes failed: {failed}")
    ranks = [dict(np.load(os.path.join(workdir, f"rank{r}.npz"))) for r in range(4)]
    shutil.rmtree(workdir, ignore_errors=True)
    counts = [json.loads(str(r["counts"])) for r in ranks]
    need = ("norms", "rmsnorm_vjp", "silu_fwd", "silu_bwd", "rope_head_first", "flash_swa_fwd", "flash_swa_dq",
            "flash_swa_dkv", "flce_stats", "flce_dz", "flce_dx", "flce_dw")
    missing = [(r, k) for r, c in enumerate(counts) for k in need if not c.get(k)]
    if missing or any(bool(r["golden_moved"]) for r in ranks):
        raise AssertionError(f"train dp 2 x tp 2: kernels not launched {missing} or a golden route taken")
    if not all("gloo" in str(r["ring"]) for r in ranks):
        raise AssertionError(f"train dp 2 x tp 2: the ring ops did not refuse CUDA tensors over gloo: "
                             f"{[str(r['ring']) for r in ranks]}")
    losses = [float(r["loss"]) for r in ranks]
    ref_loss = float(ranks[0]["ref_loss"])
    gap = max(abs(v - ref_loss) / abs(ref_loss) for v in losses)
    worst = min(((float(c), str(n), rank) for rank, r in enumerate(ranks) for n, c in zip(r["cos_names"], r["cos"])))
    per_rank = [round(float(r["cos"].min()), 6) for r in ranks]
    log("train parallel", f"{card}: (b) dp 2 x tp 2 in four processes on the one card over gloo, {TRAIN_DP_LAYERS} "
                          f"layers at Qwen3-4B width, B {TRAIN_BATCH} x S {TRAIN_DP_SEQ} a dp rank: dp-mean loss "
                          f"{losses} vs the unsharded step's {ref_loss:.9g} on the whole batch (relative gap "
                          f"{gap:.3g}, bound {TRAIN_DP_LOSS_REL_BOUND}); gradient cosine against the unsharded "
                          f"gradient's shard, lowest a rank {per_rank}, worst {worst} (bound {TRAIN_DP_COSINE_BOUND}); "
                          f"vocab shards {[tuple(int(v) for v in r['vocab']) for r in ranks]}; launches (rank 0) "
                          f"{ {k: v for k, v in counts[0].items() if v} }; the ring ops refuse CUDA tensors over gloo; "
                          f"sharded step ms {[round(float(r['step_ms']), 1) for r in ranks]} (gloo through the host); "
                          f"peak GiB {[round(float(r['peak_gib']), 1) for r in ranks]}; "
                          f"{time.perf_counter() - t0:.1f} s with the processes' start")
    if gap > TRAIN_DP_LOSS_REL_BOUND or worst[0] < TRAIN_DP_COSINE_BOUND:
        raise AssertionError(f"train dp 2 x tp 2: the step parts from the unsharded: loss gap {gap}, worst {worst}")
    return {k: v for k, v in counts[0].items() if v}


def phase_train_parallel(torch, card: str) -> dict:
    """Phase 23: dp x tp training and the rest of the distributed layer (see the module docstring): (a) on one-rank
    NCCL groups the sharded train step against the unsharded one, speculative decoding on graphs, the ring ops;
    (b) dp 2 x tp 2 in four gloo processes. (Its tp 2 speculative and C8 runs ride phase 18's spawn.) Returns the
    launches by path."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from mojo_opset_tpu_torch.parallel import build_mesh, init_distributed

    gc.collect()
    torch.cuda.empty_cache()
    rendezvous = tempfile.mkdtemp(prefix="train_tp1_")
    init_distributed(0, 1, f"file://{rendezvous}/rendezvous", device="cuda")
    mesh = build_mesh((1, 1), ("dp", "tp"))
    counts = {"train_tp1": _train_tp1(torch, card, mesh)}
    counts["speculative_nccl"] = _speculative_nccl(torch, card, mesh)
    _ring_one_rank(torch, card, mesh)
    dist.destroy_process_group()
    shutil.rmtree(rendezvous, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    counts["train_dp2_tp2"] = _train_dp2_tp2(torch, card)
    return counts


def kernels_line(record: dict, counts: dict, bf16_counts: dict, spec_counts: dict, moe_counts: dict,
                 deepseek_counts: dict, train_counts: dict, seed_counts: dict, seed_int8_counts: dict,
                 dit_counts: dict, fn_counts: dict, res_counts: dict, conv_counts: dict, quant_counts: dict,
                 t2v_counts: dict, parallel_counts: dict, rest_counts: dict) -> list:
    """One entry per kernel: launches from the int8 full-width run (it runs
    the first six), for G from the w4a8 speculative run, for H from the
    MoE run, for I from the DeepSeek run, for J, K, L, M and N from the
    training run, for O's forward from the Wan DiT's ragged run and for its
    dq and dk/dv from the diffusion Function's, for P from the residual-add
    norm's run, for Q from the conv Function's and for R from phase 8's w8a8
    half (``quant_counts``: phase 8's w8a8 and w4a8 and phase 9's w8a8
    counts, by path), and J's and A's launches on phase 16's text -> DiT
    path (``t2v_counts``), on phase 18's sharded paths (``parallel_counts``) and A's, J's, H's, C's and D's on phase
    20's runs (``rest_counts``) beside them; numbers of the main-path
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
        for key in ("int8_pages", "vocab_shard_tp2", "vocab_shard_tp4", "wan_dit_sdpa", "wan_dit_clip_sdpa",
                    "window_ctx32k", "no_window_ctx32k",
                    "window_ctx32k_int8", "no_window_ctx32k_int8", "sdar_gqa", "wan_dit_key_padding",
                    *(f"bs{bs}_ctx4000" for bs in DECODE_GRID_BS)):
            if key in rec:
                extra[key] = rec.pop(key)
        for path, path_counts in (("bf16", bf16_counts), ("w4a8_speculative", spec_counts), ("moe", moe_counts),
                                  ("deepseek", deepseek_counts), ("train", train_counts), ("seed_oss", seed_counts),
                                  ("seed_oss_int8", seed_int8_counts), ("wan_dit", dit_counts),
                                  ("diffusion_function", fn_counts), ("residual_add_norm", res_counts),
                                  ("conv_function", conv_counts), ("wan_t2v", t2v_counts), ("rest_ops", rest_counts),
                                  *quant_counts.items(), *parallel_counts.items()):
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
        """A model phase (5-12, 18, 19, 21, 23): no op of the path may take a golden route."""
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
    dit_counts, wan_dit = model_phase("wan dit", phase_wan_dit, torch, card)
    log("golden routes", f"every golden_calls stayed put over phases 5-12: {golden_counts()}")
    t2v_counts = timed("wan t2v", phase_wan_t2v, torch, card, wan_dit)  # frees phase 12's DiT pair
    fn_counts = timed("diffusion function", phase_diffusion_function, torch, card)
    res_counts = timed("residual add norm", phase_residual_add_norm, torch, card)
    conv_counts = timed("conv function", phase_conv_function, torch, card)
    timed("capture", phase_capture, torch)
    parallel_counts = model_phase("parallel", phase_parallel, torch, card)
    tooling_counts = model_phase("tooling", phase_tooling, torch, card)
    rest_counts = timed("rest ops", phase_rest_ops, torch, card)
    hf_counts = model_phase("hf checkpoint", phase_hf_checkpoint, torch, card)
    harness_counts = timed("harness", phase_harness, torch, card)
    train_parallel_counts = model_phase("train parallel", phase_train_parallel, torch, card)
    line = kernels_line(record, counts, bf16_counts, spec_counts, moe_counts, deepseek_counts, train_counts,
                        seed_counts, seed_int8_counts, dit_counts, fn_counts, res_counts, conv_counts, quant_counts,
                        t2v_counts, {**parallel_counts, **tooling_counts, **hf_counts, **harness_counts,
                                     **train_parallel_counts}, rest_counts)
    next(k for k in line if k["name"] == KERNEL_INFO["int4_matmul"][0])["launches_by_route"] = spec_routes
    next(k for k in line if k["name"] == KERNEL_INFO["group_quant_gemm"][0])["launches_by_route"] = R_ROUTES
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
