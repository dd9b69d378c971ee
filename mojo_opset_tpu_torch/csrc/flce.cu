// Kernel N: fused linear + cross-entropy (flce), forward statistics and
// backward, without storing the logits between the two.
//
// Replaces the JAX package's backends/pallas/kernels/flce.py:324 (flce:
// _stats_kernel :58, call :120; _dx_kernel :171, call :241; _dw_kernel
// :192, call :266).
//
// From x (N, H), w (V, H) of one dtype and an int32 target (N,), with
// z = x w^T in fp32 and zc = tanh(z / softcap) * softcap when a softcap is
// set:
//   stats  per row, over the columns < V: lse = log sum exp zc, the target's
//          zc (0 when the target is not in [0, V)) and zsum = sum zc;
//   dz     dz = p a - c ((1 - s) onehot + s / Vs), p = exp(zc - lse), times
//          (1 - (zc / softcap)^2) under a softcap, rounded to x's dtype
//          (a and c are the per-row coefficients of the caller's assembly;
//          Vs is the whole vocabulary, V where w holds all of it, the
//          caller's spread s / Vs);
//   dx     dx = dz w, fp32 sums, in x's dtype;
//   dw     dw = dz^T x, fp32 sums, in w's dtype.
//
// Bound on the H100: operations. At Qwen3-4B's lm_head (N 4096, H 2560, V
// 151936) each of the four products is 2 N H V = 3.19 TFLOP, 3.2 ms at the
// bf16 peak, against 0.8 GB of x and w (and 1.2 GB of bf16 dz).
//
// Design. The TPU kernel keeps (bn, H) and (bv, H) fp32 accumulators in
// VMEM and recomputes z in both backward kernels. 2.5 MiB accumulators do
// not fit an SM (227 KB), so here every product runs one mainloop with its
// own epilogue on the accumulator registers. bf16/fp16: Hopper's wgmma
// (hopper.cuh). A block of three warpgroups holds one SM: the first thread
// of the third (40 registers after setmaxnreg) keeps a ring of 4 stages
// (6 at a 128-wide tile) of TMA loads in flight, 64-deep slices of A and B
// in the 128-byte swizzle, each stage behind a full and an empty mbarrier;
// the two consumer warpgroups (232 registers) each own 64 rows of a
// 128 x 256 output tile (128 x 128 for dx) and run m64nNk16 wgmmas from
// shared memory, one group in flight while the next stage lands. The grid
// is persistent: one block an SM walks its work units, so a tile's
// epilogue overlaps the next tile's loads. Operands that are not
// K-contiguous (w in dx; dz and x in dw) are read MN-major through the
// wgmma transpose bits, from TMA boxes of 64 (M or N) x 64 (K). Tensor
// maps are encoded on each call and passed as __grid_constant__ kernel
// parameters; rows must start on 16 bytes (H % 8 == 0, the dz row pitch a
// multiple of 8 elements). TMA zero-fills out-of-bounds rows and columns,
// so z there is 0, not -inf: stats and dz mask the columns >= V (V =
// 151936 leaves a ragged last 256-wide tile).
//   (a) stats: one block per (row tile, vocab split), as many splits as
//       fill the card in one wave, walks its split's vocab tiles keeping
//       per-row online (max, sum), target logit and zsum in registers (a
//       row lives in 4 lanes of one warp), merges the 4 lanes at the end
//       and writes one partial per (split, row); a second pass merges the
//       splits in split order.
//   (b) dz: the units are (row tile, vocab tile), row tile fastest: z is
//       recomputed, dz formed in registers and stored in the input dtype,
//       for a run of rows.
//   (c) dx and dw: plain products over that dz, column tile fastest. dw of
//       later runs adds into an fp32 (V, H) buffer in a fixed order and
//       the last run rounds it.
// So the backward costs three products where JAX's costs four (it
// recomputes z in both of its kernels), and dz is the largest temporary:
// N V elements of the input dtype, or a run of its rows. No atomics and a
// fixed order everywhere: every result repeats bit for bit. fp32 inputs
// (tests only) take scalar FMAs on 128 x 128 tiles fed by a 3-stage
// cp.async ring, with the same epilogues: a route by dtype, since the
// tensor cores have no exact fp32 product (TF32 would miss the limits).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float capped(float z, float softcap) {
  return softcap > 0.0f ? tanhf(z / softcap) * softcap : z;
}

// merge two online (max, sum) pairs
__device__ __forceinline__ void merge_ms(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

// dz of one logit: the softmax term, the target and smoothing terms, the softcap's chain rule
__device__ __forceinline__ float dz_of(float z, int v, int t, float l, float ar, float cr, float softcap,
                                      float smoothing, float spread) {
  const float zc = capped(z, softcap);
  float d = expf(zc - l) * ar - cr * ((v == t ? 1.0f - smoothing : 0.0f) + spread);
  if (softcap > 0.0f) {
    const float u = zc / softcap;
    d *= 1.0f - u * u;
  }
  return d;
}

// merge the splits of each row in split order
__global__ void flce_stats_merge_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                        float* __restrict__ tl, float* __restrict__ zs, int N, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int64_t plane = static_cast<int64_t>(splits) * N;
  float m = part[r], s = part[plane + r], t = part[2 * plane + r], z = part[3 * plane + r];
  for (int q = 1; q < splits; ++q) {
    const int64_t at = static_cast<int64_t>(q) * N + r;
    merge_ms(m, s, part[at], part[plane + at]);
    t += part[2 * plane + at];
    z += part[3 * plane + at];
  }
  lse[r] = m + logf(s);
  tl[r] = t;
  zs[r] = z;
}

template <typename KernelFn>
cudaError_t allow_smem(KernelFn* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// vocab splits of the statistics pass: as many as fill `slots` blocks with
// `row_tiles` row tiles, none empty
void stats_splits(int row_tiles, int vtiles, int slots, int max_splits, int& splits, int& per_split) {
  splits = min(max(1, slots / row_tiles), min(vtiles, max_splits));
  per_split = (vtiles + splits - 1) / splits;
  splits = (vtiles + per_split - 1) / per_split;
}

// ---------------------------------------------------------------------------
// fp32: scalar FMAs on 128 x 128 tiles (tests only)
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBM = 128, kBN = 128;  // output tile (rows of A x rows of B)
constexpr int kThreads = 256;
constexpr int kWarpsN = 2;
constexpr int kWM = 32, kWN = 64;  // warp tile: 4 warps along M, 2 along N
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kStages = 3;
constexpr int BK = 16;
constexpr int CH = 4;                                       // floats of a 16-byte chunk
constexpr int LDK = BK + CH;                                // row of a K-contiguous tile [128][LDK]
constexpr int LDR = kBM + CH;                               // row of an R-contiguous tile [BK][LDR]
constexpr int OP = (kBM * LDK > BK * LDR) ? kBM * LDK : BK * LDR;
constexpr int STAGE = 2 * OP;
constexpr int SMEM = kStages * STAGE * static_cast<int>(sizeof(float));

// One operand of a product: "rows" (the M index of A, the N index of B) by
// K. K-contiguous (KC): element (r, k) at p[r * ld + k], else at
// p[k * ld + r]. r_lim and k_lim bound what is read; the rest is zeros.
struct Operand {
  const float* p;
  int64_t ld;
  int r_lim;
  int k_lim;
};

template <bool KC>
__device__ __forceinline__ void load_tile(float* dst, const Operand& op, int r0, int k0, int tid) {
  if constexpr (KC) {
    constexpr int KCH = BK / CH;
    for (int c = tid; c < kBM * KCH; c += kThreads) {
      const int r = r0 + c / KCH, kc = (c % KCH) * CH, k = k0 + kc;
      const int n = r < op.r_lim ? max(0, min(CH, op.k_lim - k)) : 0;
      cp_async16_zfill(dst + (c / KCH) * LDK + kc, n ? op.p + static_cast<int64_t>(r) * op.ld + k : op.p, n * 4);
    }
  } else {
    constexpr int RCH = kBM / CH;
    for (int c = tid; c < BK * RCH; c += kThreads) {
      const int k = k0 + c / RCH, rc = (c % RCH) * CH, r = r0 + rc;
      const int n = k < op.k_lim ? max(0, min(CH, op.r_lim - r)) : 0;
      cp_async16_zfill(dst + (c / RCH) * LDR + rc, n ? op.p + static_cast<int64_t>(k) * op.ld + r : op.p, n * 4);
    }
  }
}

// acc[i][j][2h + e] is the output element at tile row
// wm * 32 + i * 16 + g + 8h and tile column wn * 64 + j * 8 + 2 tig + e.
struct Lane {
  int g, tig, wm, wn;
  __device__ Lane() {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    g = lane / 4;
    tig = lane % 4;
    wm = warp / kWarpsN;
    wn = warp % kWarpsN;
  }
  __device__ int row(int i, int h) const { return wm * kWM + i * 16 + g + 8 * h; }
  __device__ int col(int j, int e) const { return wn * kWN + j * 8 + 2 * tig + e; }
};

template <bool AKC, bool BKC>
__device__ __forceinline__ void compute_stage(float (&acc)[kMT][kNT][4], const float* as, const float* bs,
                                              const Lane& ln) {
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float av[kMT][2], bv[kNT][2];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.row(i, h);
        av[i][h] = AKC ? as[r * LDK + k] : as[k * LDR + r];
      }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = ln.col(j, e);
        bv[j][e] = BKC ? bs[n * LDK + k] : bs[k * LDR + n];
      }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[i][j][2 * h + e] = fmaf(av[i][h], bv[j][e], acc[i][j][2 * h + e]);
  }
}

// acc = A[m0:m0+128, 0:K] B[n0:n0+128, 0:K]^T over the cp.async ring in
// `smem`. Ends with every copy landed and every thread past its last read.
template <bool AKC, bool BKC>
__device__ void tile_product(float (&acc)[kMT][kNT][4], float* smem, const Operand& A, const Operand& B, int m0,
                             int n0, int K, const Lane& ln) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int k_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      load_tile<AKC>(smem + s * STAGE, A, m0, s * BK, tid);
      load_tile<BKC>(smem + s * STAGE + OP, B, n0, s * BK, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      float* st = smem + (next % kStages) * STAGE;
      load_tile<AKC>(st, A, m0, next * BK, tid);
      load_tile<BKC>(st + OP, B, n0, next * BK, tid);
    }
    cp_async_commit();
    const float* st = smem + (kt % kStages) * STAGE;
    compute_stage<AKC, BKC>(acc, st, st + OP, ln);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// (a) statistics: block (row tile, split) walks vocab tiles
// [split * per_split, min(vtiles, (split + 1) * per_split)) and writes
// part[q][split][row] for q = max, sum, target logit, zsum.
__global__ void __launch_bounds__(kThreads)
flce_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ target,
                      float* __restrict__ part, int N, int H, int V, int per_split, int splits, float softcap) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  __shared__ float red[kWarpsN][kBM][4];
  float* smem = reinterpret_cast<float*>(flce_smem_raw);
  const Lane ln;
  const int m0 = blockIdx.x * kBM, split = blockIdx.y;
  const int vtiles = (V + kBN - 1) / kBN;
  const int vt_lo = split * per_split, vt_hi = min(vtiles, vt_lo + per_split);
  const Operand A{x, H, N, H}, B{w, H, V, H};

  float m[kMT][2], s[kMT][2], tl[kMT][2], zs[kMT][2];
  int t[kMT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + ln.row(i, h);
      m[i][h] = kNegBig;
      s[i][h] = tl[i][h] = zs[i][h] = 0.0f;
      t[i][h] = r < N ? target[r] : -1;
    }

  float acc[kMT][kNT][4];
  for (int vt = vt_lo; vt < vt_hi; ++vt) {
    const int n0 = vt * kBN;
    tile_product<true, true>(acc, smem, A, B, m0, n0, H, ln);
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mt = kNegBig;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int v = n0 + ln.col(j, e);
            const float z = capped(acc[i][j][2 * h + e], softcap);
            acc[i][j][2 * h + e] = z;
            if (v < V) {
              mt = fmaxf(mt, z);
              zs[i][h] += z;
              if (v == t[i][h]) tl[i][h] += z;
            }
          }
        const float nm = fmaxf(m[i][h], mt);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n0 + ln.col(j, e) < V) sum += expf(acc[i][j][2 * h + e] - nm);
        s[i][h] = s[i][h] * expf(m[i][h] - nm) + sum;
        m[i][h] = nm;
      }
  }

  // the 4 lanes of a row, then the 2 warps along N
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m[i][h], o);
        const float os = __shfl_xor_sync(0xffffffffu, s[i][h], o);
        merge_ms(m[i][h], s[i][h], om, os);
        tl[i][h] += __shfl_xor_sync(0xffffffffu, tl[i][h], o);
        zs[i][h] += __shfl_xor_sync(0xffffffffu, zs[i][h], o);
      }
      if (ln.tig == 0) {
        float* dst = red[ln.wn][ln.row(i, h)];
        dst[0] = m[i][h];
        dst[1] = s[i][h];
        dst[2] = tl[i][h];
        dst[3] = zs[i][h];
      }
    }
  __syncthreads();
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    if (m0 + r >= N) continue;
    float mm = red[0][r][0], ss = red[0][r][1], tt = red[0][r][2], zz = red[0][r][3];
#pragma unroll
    for (int q = 1; q < kWarpsN; ++q) {
      merge_ms(mm, ss, red[q][r][0], red[q][r][1]);
      tt += red[q][r][2];
      zz += red[q][r][3];
    }
    const int64_t at = static_cast<int64_t>(split) * N + m0 + r, plane = static_cast<int64_t>(splits) * N;
    part[at] = mm;
    part[plane + at] = ss;
    part[2 * plane + at] = tt;
    part[3 * plane + at] = zz;
  }
}

// (b) dz for rows [r0, r0 + rows): block (row tile, vocab tile)
__global__ void __launch_bounds__(kThreads)
flce_dz_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ target,
                   const float* __restrict__ lse, const float* __restrict__ a, const float* __restrict__ c,
                   float* __restrict__ dz, int r0, int rows, int H, int V, int ldz, float softcap, float smoothing,
                   float spread) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  float* smem = reinterpret_cast<float*>(flce_smem_raw);
  const Lane ln;
  const int m0 = r0 + blockIdx.x * kBM, n0 = blockIdx.y * kBN, r_end = r0 + rows;
  const Operand A{x, H, r_end, H}, B{w, H, V, H};
  float acc[kMT][kNT][4];
  tile_product<true, true>(acc, smem, A, B, m0, n0, H, ln);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + ln.row(i, h);
      if (r >= r_end) continue;
      const float l = lse[r], ar = a[r], cr = c[r];
      const int t = target[r];
      float* out = dz + static_cast<int64_t>(r - r0) * ldz;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = n0 + ln.col(j, e);
          if (v < V) out[v] = dz_of(acc[i][j][2 * h + e], v, t, l, ar, cr, softcap, smoothing, spread);
        }
    }
}

// (c) out[m, n] = sum_k A[m, k] B[n, k]; mode 0 stores, 1 stores the fp32
// buffer, 2 adds into it, 3 stores buffer + acc
template <bool AKC, bool BKC>
__global__ void __launch_bounds__(kThreads)
flce_gemm_f32_kernel(Operand A, Operand B, float* __restrict__ out, float* __restrict__ buf, int M, int N, int K,
                     int mode) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  float* smem = reinterpret_cast<float*>(flce_smem_raw);
  const Lane ln;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  float acc[kMT][kNT][4];
  tile_product<AKC, BKC>(acc, smem, A, B, m0, n0, K, ln);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + ln.row(i, h);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + ln.col(j, e);
          if (n >= N) continue;
          const int64_t at = static_cast<int64_t>(m) * N + n;
          const float v = acc[i][j][2 * h + e];
          if (mode == 0) {
            out[at] = v;
          } else if (mode == 1) {
            buf[at] = v;
          } else if (mode == 2) {
            buf[at] += v;
          } else {
            out[at] = buf[at] + v;
          }
        }
    }
}

int stats(const float* x, const float* w, const int* target, float* part, float* lse, float* tl, float* zs, int N,
          int H, int V, int max_splits, float softcap, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(flce_stats_f32_kernel, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int slots = [] {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flce_stats_f32_kernel, kThreads, SMEM);
    return max(per_sm, 1) * sm_count();
  }();
  const int row_tiles = (N + kBM - 1) / kBM, vtiles = (V + kBN - 1) / kBN;
  int splits, per_split;
  stats_splits(row_tiles, vtiles, slots, max_splits, splits, per_split);
  flce_stats_f32_kernel<<<dim3(row_tiles, splits), kThreads, SMEM, s>>>(x, w, target, part, N, H, V, per_split,
                                                                        splits, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flce_stats_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, lse, tl, zs, N, splits);
  return static_cast<int>(cudaGetLastError());
}

int dz(const float* x, const float* w, const int* target, const float* lse, const float* a, const float* c,
       float* out, int r0, int rows, int H, int V, int ldz, float softcap, float smoothing, float spread,
       cudaStream_t s) {
  static const cudaError_t attr = allow_smem(flce_dz_f32_kernel, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((rows + kBM - 1) / kBM, (V + kBN - 1) / kBN);
  flce_dz_f32_kernel<<<grid, kThreads, SMEM, s>>>(x, w, target, lse, a, c, out, r0, rows, H, V, ldz, softcap,
                                                  smoothing, spread);
  return static_cast<int>(cudaGetLastError());
}

template <bool AKC, bool BKC>
int gemm(const Operand& A, const Operand& B, float* out, float* buf, int M, int N, int K, int mode, cudaStream_t s) {
  static const cudaError_t attr = allow_smem(flce_gemm_f32_kernel<AKC, BKC>, SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  flce_gemm_f32_kernel<AKC, BKC><<<grid, kThreads, SMEM, s>>>(A, B, out, buf, M, N, K, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma + TMA, warp-specialized, persistent
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBM = 128;       // tile rows: two consumer warpgroups of 64
constexpr int kBK = 64;        // K of a stage: one 128-byte swizzle row of 16-bit elements
constexpr int kThreads = 384;  // warpgroups 0-1 consume; warpgroup 2's first thread loads
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kBK == kSw128K, "a stage is one 128-byte swizzle row deep");

template <int BN>
struct Ring {
  static constexpr int kABytes = kBM * kBK * 2;
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  static constexpr int kStages = BN == 256 ? 4 : 6;
  // the stages, slack to align them on 1024 bytes, a full and an empty barrier a stage
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

// Units of one launch over m_tiles x n_tiles output tiles, each the
// product over k_tiles stages or, with k_splits > 1, over one of k_splits
// consecutive ranges of them: a unit is one row tile, a run of up to
// per_unit consecutive column tiles and one K range; units go to the
// blocks round-robin, numbered row tile fastest when m_fast, K range
// slowest.
struct Sched {
  int m_tiles, n_tiles, k_tiles, per_unit, m_fast, k_splits;
  __host__ __device__ int runs() const { return (n_tiles + per_unit - 1) / per_unit; }
  __host__ __device__ int units() const { return m_tiles * runs() * k_splits; }
  __device__ void unit(int u, int& m, int& run, int& n_lo, int& n_hi, int& ks, int& kt_lo, int& kt_hi) const {
    const int per_k = m_tiles * runs(), kc = (k_tiles + k_splits - 1) / k_splits;
    ks = u / per_k;
    u %= per_k;
    m = m_fast ? u % m_tiles : u / runs();
    run = m_fast ? u / m_tiles : u % runs();
    n_lo = run * per_unit;
    n_hi = min(n_tiles, n_lo + per_unit);
    kt_lo = ks * kc;
    kt_hi = min(k_tiles, kt_lo + kc);
  }
};

enum Kind : int { kStats = 0, kDz = 1, kStore = 2 };

// What the epilogues read and write; each kind uses its own fields.
struct Epi {
  const int* target;   // stats, dz
  const float* lse;    // dz
  const float* a;      // dz
  const float* c;      // dz
  float* part;         // stats: partials [4][splits][M]
  void* out;           // dz, store: (M, N) of T, row pitch ld
  float* buf;          // store: the fp32 (M, N) buffer of modes 1-3
  int M, N;            // valid rows and columns of the output (stats, dz: N = V)
  int64_t ld;
  int splits, mode;
  float softcap, smoothing, spread;  // dz: spread = smoothing / the vocabulary's size (a shard's V is less)
};

template <typename T, int BN, bool AMN, bool BMN>
__device__ __forceinline__ void stage_product(float (&acc)[BN / 2], uint32_t a_tile, uint32_t b_tile, int half) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = sw128_operand_desc<AMN>(a_tile, 64 * half, kk);
    const uint64_t db = sw128_operand_desc<BMN>(b_tile, 0, kk);
    if constexpr (BN == 256) {
      wgmma_m64n256k16<T, AMN, BMN>(acc, da, db);
    } else {
      wgmma_m64n128k16<T, AMN, BMN>(acc, da, db);
    }
  }
}

// acc[4j + 2h + e] is the output element at row `row + 8h` (the tile's
// row tile and this thread's row in it) and column `col + 8j + e`; with
// K ranges, range ks writes its fp32 partial to buffer plane ks (mode 1)
template <typename T, int BN, int KIND>
__device__ __forceinline__ void store_tile(const Epi& p, float (&acc)[BN / 2], int row, int col, int ks) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= p.M) continue;
    float l = 0.f, ar = 0.f, cr = 0.f;
    int t = -1;
    if constexpr (KIND == kDz) {
      l = p.lse[r];
      ar = p.a[r];
      cr = p.c[r];
      t = p.target[r];
    }
    T* out = static_cast<T*>(p.out) + r * p.ld;
    float* buf = p.buf + (static_cast<int64_t>(ks) * p.M + r) * p.ld;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int v = col + 8 * j;
      if (v >= p.N) continue;
      float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if constexpr (KIND == kDz) {
        x = dz_of(x, v, t, l, ar, cr, p.softcap, p.smoothing, p.spread);
        y = dz_of(y, v + 1, t, l, ar, cr, p.softcap, p.smoothing, p.spread);
      } else if (p.mode == 1 || p.mode == 2) {
        if (v + 1 < p.N) {
          float2 old = p.mode == 2 ? *reinterpret_cast<const float2*>(buf + v) : make_float2(0.f, 0.f);
          *reinterpret_cast<float2*>(buf + v) = make_float2(old.x + x, old.y + y);
        } else {
          buf[v] = p.mode == 2 ? buf[v] + x : x;
        }
        continue;
      } else if (p.mode == 3) {
        x += buf[v];
        if (v + 1 < p.N) y += buf[v + 1];
      }
      if (v + 1 < p.N) {
        mojo_store2<T>(out + v, x, y);
      } else {
        out[v] = mojo_from_float<T>(x);
      }
    }
  }
}

// Per-row online statistics of the rows `row` and `row + 8` over one tile
// (stats): columns at or past V are zero-filled by TMA and masked here.
template <int BN>
__device__ __forceinline__ void stats_tile(const Epi& p, float (&acc)[BN / 2], int col, const int (&t)[2],
                                           float (&m)[2], float (&s)[2], float (&tl)[2], float (&zs)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mt = kNegBig;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = col + 8 * j + e;
        const float z = capped(acc[4 * j + 2 * h + e], p.softcap);
        acc[4 * j + 2 * h + e] = z;
        if (v < p.N) {
          mt = fmaxf(mt, z);
          zs[h] += z;
          if (v == t[h]) tl[h] += z;
        }
      }
    const float nm = fmaxf(m[h], mt);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + 8 * j + e < p.N) sum += expf(acc[4 * j + 2 * h + e] - nm);
    s[h] = s[h] * expf(m[h] - nm) + sum;
    m[h] = nm;
  }
}

template <typename T, int BN, bool AMN, bool BMN, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
flce_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  const Sched sched, const Epi epi) {
  using Rg = Ring<BN>;
  extern __shared__ __align__(16) uint8_t flce_wg_raw[];
  uint8_t* tiles = flce_wg_raw + (1024 - smem_addr(flce_wg_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + Rg::kStages * Rg::kStageBytes);
  uint64_t* empty = full + Rg::kStages;
  const int role = threadIdx.x / 128;  // warpgroup: 0, 1 consume, 2 loads
  if (threadIdx.x == 0) {
    for (int st = 0; st < Rg::kStages; ++st) {
      mbar_init(&full[st], 1);  // the producer's arrive, plus the stage's bytes
      mbar_init(&empty[st], 8);  // one arrive from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (role == 2) {
    // producer: one thread keeps the ring full, in the consumers' order
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < sched.units(); u += gridDim.x) {
        int m, run, n_lo, n_hi, ks, kt_lo, kt_hi;
        sched.unit(u, m, run, n_lo, n_hi, ks, kt_lo, kt_hi);
        for (int n = n_lo; n < n_hi; ++n) {
          for (int kt = kt_lo; kt < kt_hi; ++kt) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* st = tiles + stage * Rg::kStageBytes;
            mbar_expect_tx(&full[stage], Rg::kStageBytes);
            tma_load_operand<kBM, AMN>(st, &map_a, &full[stage], m * kBM, kt * kBK);
            tma_load_operand<BN, BMN>(st + Rg::kABytes, &map_b, &full[stage], n * BN, kt * kBK);
            if (++stage == Rg::kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup `role` owns rows [64 role, 64 role + 64) of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row_in_tile = 64 * role + 16 * warp + lane / 4, col_in_tile = 2 * (lane % 4);
    const uint32_t ring = smem_addr(tiles);
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < sched.units(); u += gridDim.x) {
      int m, run, n_lo, n_hi, ks, kt_lo, kt_hi;
      sched.unit(u, m, run, n_lo, n_hi, ks, kt_lo, kt_hi);
      const int row = m * kBM + row_in_tile;
      // stats: the online state of this thread's two rows over the unit's vocab tiles
      float sm[2] = {kNegBig, kNegBig}, ss[2] = {0.f, 0.f}, stl[2] = {0.f, 0.f}, szs[2] = {0.f, 0.f};
      int tgt[2] = {-1, -1};
      if constexpr (KIND == kStats) {
#pragma unroll
        for (int h = 0; h < 2; ++h) tgt[h] = row + 8 * h < epi.M ? epi.target[row + 8 * h] : -1;
      }
      for (int n = n_lo; n < n_hi; ++n) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        int prev = -1;
        for (int kt = kt_lo; kt < kt_hi; ++kt) {
          mbar_wait(&full[stage], phase);
          const uint32_t a_tile = ring + stage * Rg::kStageBytes;
          wgmma_hold(acc);
          wgmma_fence();
          stage_product<T, BN, AMN, BMN>(acc, a_tile, a_tile + Rg::kABytes, role);
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: release it
          wgmma_hold(acc);
          if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
          prev = stage;
          if (++stage == Rg::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        wgmma_hold(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        const int col = n * BN + col_in_tile;
        if constexpr (KIND == kStats) {
          stats_tile<BN>(epi, acc, col, tgt, sm, ss, stl, szs);
        } else {
          store_tile<T, BN, KIND>(epi, acc, row, col, ks);
        }
      }
      if constexpr (KIND == kStats) {
        // the 4 lanes of each row, in a fixed order, then one partial per (split, row)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const float om = __shfl_xor_sync(0xffffffffu, sm[h], o);
            const float os = __shfl_xor_sync(0xffffffffu, ss[h], o);
            merge_ms(sm[h], ss[h], om, os);
            stl[h] += __shfl_xor_sync(0xffffffffu, stl[h], o);
            szs[h] += __shfl_xor_sync(0xffffffffu, szs[h], o);
          }
          const int r = row + 8 * h;
          if (lane % 4 == 0 && r < epi.M) {
            const int64_t at = static_cast<int64_t>(run) * epi.M + r, plane = static_cast<int64_t>(epi.splits) * epi.M;
            epi.part[at] = sm[h];
            epi.part[plane + at] = ss[h];
            epi.part[2 * plane + at] = stl[h];
            epi.part[3 * plane + at] = szs[h];
          }
        }
      }
    }
  }
}

template <typename T, int BN, bool AMN, bool BMN, int KIND>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const Sched& sched, const Epi& epi, int grid,
           cudaStream_t s) {
  auto* kernel = flce_wgmma_kernel<T, BN, AMN, BMN, KIND>;
  static const cudaError_t attr = allow_smem(kernel, Ring<BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (sched.units() == 0) return static_cast<int>(cudaSuccess);
  kernel<<<grid, kThreads, Ring<BN>::kSmem, s>>>(map_a, map_b, sched, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int maps(CUtensorMap* map, const void* base, int inner, int outer, int64_t pitch, int box_rows) {
  return encode_tile_map(map, std::is_same_v<T, __nv_bfloat16>, base, inner, outer, pitch * sizeof(T), box_rows);
}

constexpr int kStatsBN = 256, kDzBN = 256, kDxBN = 256, kDwBN = 256;

template <typename T>
int stats(const T* x, const T* w, const int* target, float* part, float* lse, float* tl, float* zs, int N, int H,
          int V, int max_splits, float softcap, cudaStream_t s) {
  CUtensorMap ma, mb;
  int rc = maps<T>(&ma, x, H, N, H, kBM);
  if (rc == 0) rc = maps<T>(&mb, w, H, V, H, kStatsBN);
  if (rc != 0) return rc;
  const int row_tiles = (N + kBM - 1) / kBM, vtiles = (V + kStatsBN - 1) / kStatsBN;
  int splits, per_split;
  stats_splits(row_tiles, vtiles, sm_count(), max_splits, splits, per_split);
  const Sched sched{row_tiles, vtiles, (H + kBK - 1) / kBK, per_split, 1, 1};
  Epi epi{};
  epi.target = target;
  epi.part = part;
  epi.M = N;
  epi.N = V;
  epi.splits = splits;
  epi.softcap = softcap;
  rc = launch<T, kStatsBN, false, false, kStats>(ma, mb, sched, epi, sched.units(), s);
  if (rc != 0) return rc;
  flce_stats_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, lse, tl, zs, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dz(const T* x, const T* w, const int* target, const float* lse, const float* a, const float* c, T* out, int r0,
       int rows, int H, int V, int ldz, float softcap, float smoothing, float spread, cudaStream_t s) {
  CUtensorMap ma, mb;
  int rc = maps<T>(&ma, x + static_cast<int64_t>(r0) * H, H, rows, H, kBM);
  if (rc == 0) rc = maps<T>(&mb, w, H, V, H, kDzBN);
  if (rc != 0) return rc;
  const int row_tiles = (rows + kBM - 1) / kBM, vtiles = (V + kDzBN - 1) / kDzBN;
  const Sched sched{row_tiles, vtiles, (H + kBK - 1) / kBK, 1, 1, 1};
  Epi epi{};
  epi.target = target + r0;
  epi.lse = lse + r0;
  epi.a = a + r0;
  epi.c = c + r0;
  epi.out = out;
  epi.M = rows;
  epi.N = V;
  epi.ld = ldz;
  epi.softcap = softcap;
  epi.smoothing = smoothing;
  epi.spread = spread;
  return launch<T, kDzBN, false, false, kDz>(ma, mb, sched, epi, min(sched.units(), sm_count()), s);
}

// out (rows, cols) of T = the sum of `splits` fp32 planes of part, in plane order
template <typename T>
__global__ void flce_split_sum_kernel(const float* __restrict__ part, T* __restrict__ out, int64_t n, int splits) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 acc = *reinterpret_cast<const float2*>(part + i);
  for (int k = 1; k < splits; ++k) {
    const float2 v = *reinterpret_cast<const float2*>(part + k * n + i);
    acc.x += v.x;
    acc.y += v.y;
  }
  mojo_store2<T>(out + i, acc.x, acc.y);
}

// dx (rows, H) = dz (rows, V) w (V, H): dz K-major, w MN-major; with
// k_splits > 1 the V range is split, each range's fp32 sums go to a plane
// of part (k_splits x rows x H) and a second pass adds the planes in order
template <typename T>
int dx(const T* dzp, const T* w, T* out, float* part, int rows, int H, int V, int ldz, int k_splits, cudaStream_t s) {
  CUtensorMap ma, mb;
  int rc = maps<T>(&ma, dzp, V, rows, ldz, kBM);
  if (rc == 0) rc = maps<T>(&mb, w, H, V, H, kBK);
  if (rc != 0) return rc;
  const int m_tiles = (rows + kBM - 1) / kBM, n_tiles = (H + kDxBN - 1) / kDxBN;
  const Sched sched{m_tiles, n_tiles, (V + kBK - 1) / kBK, 1, 0, k_splits};
  Epi epi{};
  epi.out = out;
  epi.buf = part;
  epi.mode = k_splits > 1 ? 1 : 0;
  epi.M = rows;
  epi.N = H;
  epi.ld = H;
  rc = launch<T, kDxBN, false, true, kStore>(ma, mb, sched, epi, min(sched.units(), sm_count()), s);
  if (rc != 0 || k_splits == 1) return rc;
  const int64_t n = static_cast<int64_t>(rows) * H;
  flce_split_sum_kernel<T><<<static_cast<int>((n / 2 + 255) / 256), 256, 0, s>>>(part, out, n, k_splits);
  return static_cast<int>(cudaGetLastError());
}

// dw (V, H) = dz^T (V, rows) x (rows, H): both MN-major
template <typename T>
int dw(const T* dzp, const T* x, T* out, float* buf, int rows, int H, int V, int ldz, int mode, cudaStream_t s) {
  const int m_tiles = (V + kBM - 1) / kBM, n_tiles = (H + kDwBN - 1) / kDwBN;
  const Sched sched{m_tiles, n_tiles, (rows + kBK - 1) / kBK, 1, 0, 1};
  Epi epi{};
  epi.out = out;
  epi.buf = buf;
  epi.M = V;
  epi.N = H;
  epi.ld = H;
  epi.mode = mode;
  if (rows == 0) {  // no rows: the sums are 0 (TMA takes no empty matrix)
    static const CUtensorMap none{};
    return launch<T, kDwBN, true, true, kStore>(none, none, sched, epi, min(sched.units(), sm_count()), s);
  }
  CUtensorMap ma, mb;
  int rc = maps<T>(&ma, dzp, V, rows, ldz, kBK);
  if (rc == 0) rc = maps<T>(&mb, x, H, rows, H, kBK);
  if (rc != 0) return rc;
  return launch<T, kDwBN, true, true, kStore>(ma, mb, sched, epi, min(sched.units(), sm_count()), s);
}

}  // namespace wg

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
bool rows_ok(int H) { return H % (16 / static_cast<int>(sizeof(T))) == 0; }

// the route by dtype: fp32 on the FMA tiles, bf16/fp16 on wgmma
template <typename T>
int stats_route(const void* x, const void* w, const int* t, float* p, float* l, float* tl, float* z, int N, int H,
                int V, int max_splits, float softcap, cudaStream_t s) {
  if (!rows_ok<T>(H)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, float>) {
    return f32::stats(static_cast<const float*>(x), static_cast<const float*>(w), t, p, l, tl, z, N, H, V, max_splits,
                      softcap, s);
  } else {
    return wg::stats<T>(static_cast<const T*>(x), static_cast<const T*>(w), t, p, l, tl, z, N, H, V, max_splits,
                        softcap, s);
  }
}

template <typename T>
int dz_route(const void* x, const void* w, const int* t, const float* l, const float* a, const float* c, void* dz,
             int r0, int rows, int H, int V, int ldz, float softcap, float smoothing, float spread, cudaStream_t s) {
  if (!rows_ok<T>(H)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, float>) {
    return f32::dz(static_cast<const float*>(x), static_cast<const float*>(w), t, l, a, c, static_cast<float*>(dz),
                   r0, rows, H, V, ldz, softcap, smoothing, spread, s);
  } else {
    if (!rows_ok<T>(ldz)) return static_cast<int>(cudaErrorInvalidValue);
    return wg::dz<T>(static_cast<const T*>(x), static_cast<const T*>(w), t, l, a, c, static_cast<T*>(dz), r0, rows,
                     H, V, ldz, softcap, smoothing, spread, s);
  }
}

template <typename T>
int dx_route(const void* dz, const void* w, void* dx, float* part, int rows, int H, int V, int ldz, int k_splits,
             cudaStream_t s) {
  if (!rows_ok<T>(H) || !rows_ok<T>(ldz)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, float>) {
    const f32::Operand A{static_cast<const float*>(dz), ldz, rows, V}, B{static_cast<const float*>(w), H, H, V};
    return f32::gemm<true, false>(A, B, static_cast<float*>(dx), nullptr, rows, H, V, 0, s);
  } else {
    return wg::dx<T>(static_cast<const T*>(dz), static_cast<const T*>(w), static_cast<T*>(dx), part, rows, H, V, ldz,
                     k_splits, s);
  }
}

template <typename T>
int dw_route(const void* dz, const void* x, void* dw, float* buf, int rows, int H, int V, int ldz, int mode,
             cudaStream_t s) {
  if (!rows_ok<T>(H) || !rows_ok<T>(ldz)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (std::is_same_v<T, float>) {
    const f32::Operand A{static_cast<const float*>(dz), ldz, V, rows}, B{static_cast<const float*>(x), H, H, rows};
    return f32::gemm<false, false>(A, B, static_cast<float*>(dw), buf, V, H, rows, mode, s);
  } else {
    return wg::dw<T>(static_cast<const T*>(dz), static_cast<const T*>(x), static_cast<T*>(dw), buf, rows, H, V, ldz,
                     mode, s);
  }
}

}  // namespace

// x (N, H), w (V, H) contiguous of `dtype`, target (N,) int32; part holds
// 4 * max_splits * N floats of scratch; lse, tl, zs (N,) fp32. softcap <= 0:
// none.
extern "C" int mojo_flce_stats(const void* x, const void* w, const void* target, void* part, void* lse, void* tl,
                               void* zs, int N, int H, int V, int max_splits, float softcap, int dtype,
                               void* stream) {
  if (N <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || H <= 0 || max_splits <= 0 || !aligned16(x) || !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = stats_route<T>(x, w, static_cast<const int*>(target), static_cast<float*>(part), static_cast<float*>(lse),
                        static_cast<float*>(tl), static_cast<float*>(zs), N, H, V, max_splits, softcap,
                        static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// dz (rows, ldz) for rows [r0, r0 + rows) of x, target, lse, a and c (the
// full arrays); ldz % 8 == 0 and ldz >= V. spread is label_smoothing over the
// whole vocabulary's size, which a vocab shard's V is not.
extern "C" int mojo_flce_dz(const void* x, const void* w, const void* target, const void* lse, const void* a,
                            const void* c, void* dz, int r0, int rows, int H, int V, int ldz, float softcap,
                            float label_smoothing, float spread, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || H <= 0 || ldz < V || !aligned16(x) || !aligned16(w)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = dz_route<T>(x, w, static_cast<const int*>(target), static_cast<const float*>(lse),
                     static_cast<const float*>(a), static_cast<const float*>(c), dz, r0, rows, H, V, ldz, softcap,
                     label_smoothing, spread, static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// dx (rows, H) = dz (rows, V; row pitch ldz) w (V, H); with k_splits > 1
// (16-bit types), part holds k_splits * rows * H floats of scratch
extern "C" int mojo_flce_dx(const void* dz, const void* w, void* dx, void* part, int rows, int H, int V, int ldz,
                            int k_splits, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || H <= 0 || ldz < V || k_splits < 1 || (k_splits > 1 && part == nullptr) || !aligned16(dz) ||
      !aligned16(w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = dx_route<T>(dz, w, dx, static_cast<float*>(part), rows, H, V, ldz, k_splits,
                     static_cast<cudaStream_t>(stream));
  });
  return rc;
}

// dw (V, H) from dz (rows, V; row pitch ldz) and x (rows, H): mode 0
// dw = dz^T x; with the fp32 (V, H) buffer, 1 buf = dz^T x, 2 buf += dz^T x,
// 3 dw = buf + dz^T x
extern "C" int mojo_flce_dw(const void* dz, const void* x, void* dw, void* buf, int rows, int H, int V, int ldz,
                            int mode, int dtype, void* stream) {
  if (V <= 0 || H <= 0 || rows < 0 || ldz < V || mode < 0 || mode > 3 || (mode != 0 && buf == nullptr) ||
      !aligned16(dz) || !aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = dw_route<T>(dz, x, dw, static_cast<float*>(buf), rows, H, V, ldz, mode, static_cast<cudaStream_t>(stream));
  });
  return rc;
}
