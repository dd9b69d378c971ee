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
//   dz     dz = p a - c ((1 - s) onehot + s / V), p = exp(zc - lse), times
//          (1 - (zc / softcap)^2) under a softcap, rounded to x's dtype
//          (a and c are the per-row coefficients of the caller's assembly);
//   dx     dx = dz w, fp32 sums, in x's dtype;
//   dw     dw = dz^T x, fp32 sums, in w's dtype.
//
// Bound on the H100: operations. At Qwen3-4B's lm_head (N 4096, H 2560, V
// 151936) each of the three products is 2 N H V = 3.19 TFLOP, 3.2 ms at the
// bf16 peak, against 0.8 GB of x and w (and 1.2 GB of bf16 dz).
//
// Design. The TPU kernel keeps (bn, H) and (bv, H) fp32 accumulators in
// VMEM and recomputes z in both backward kernels. 2.5 MiB accumulators do
// not fit an SM (227 KB), so here every product is one tiled GEMM mainloop
// (128 x 128 output tiles, 8 warps of 32 x 64, mma.sync.m16n8k16 with fp32
// accumulators fed by a 3-stage cp.async ring, the fragments of kernel H)
// with its own epilogue:
//   (a) stats: a grid of (row tiles x vocab splits) so that 4096 rows fill
//       the card; each block walks its vocab tiles keeping per-thread
//       online (max, sum), target logit and zsum in registers, merges them
//       across the 4 lanes and 2 warps that share a row, and writes one
//       partial per (split, row); a second pass merges the splits in split
//       order. The split count comes from the occupancy of this build.
//   (b) dz: one block per (row tile, vocab tile) recomputes z, forms dz in
//       registers and stores it in the input dtype, for a run of rows.
//   (c) dx and dw: plain GEMMs over that dz. dw of later runs adds into an
//       fp32 (V, H) buffer in a fixed order and the last run rounds it.
// So the backward costs three products where JAX's costs four (it
// recomputes z in both of its kernels), and dz is the largest temporary:
// N V elements of the input dtype, or a run of its rows. No atomics:
// every result repeats bit for bit. Operands that are not K-contiguous
// (w in dx, dz and x in dw) build their fragments from two 16-bit shared
// loads (pack2). fp32 inputs (tests only) take FMAs on the same tiles and
// the same epilogues. Ragged edges (any N and V) are zero-filled by the
// loads; rows must start on 16 bytes: H % 8 == 0 (16-bit) or H % 4 == 0
// (fp32), and the dz row pitch a multiple of 8 elements. No TMA or wgmma
// yet.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 128;  // output tile (rows of A x rows of B)
constexpr int kThreads = 256;
constexpr int kWarpsN = 2;
constexpr int kWM = 32, kWN = 64;    // warp tile: 4 warps along M, 2 along N
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kStages = 3;
constexpr float kNegBig = -1e30f;

// shared element type: 16-bit inputs are staged as raw halves
template <typename T>
using SmemT = std::conditional_t<std::is_same_v<T, float>, float, uint16_t>;

template <typename T>
struct Cfg {
  static constexpr bool kF32 = std::is_same_v<T, float>;
  static constexpr int BK = kF32 ? 16 : 32;
  static constexpr int CH = 16 / static_cast<int>(sizeof(T));  // elements of a 16-byte chunk
  static constexpr int LDK = BK + CH;                          // row of a K-contiguous tile [128][LDK]
  static constexpr int LDR = kBM + CH;                         // row of an R-contiguous tile [BK][LDR]
  static constexpr int OP = (kBM * LDK > BK * LDR) ? kBM * LDK : BK * LDR;
  static constexpr int STAGE = 2 * OP;
  static constexpr int SMEM = kStages * STAGE * static_cast<int>(sizeof(T));
  static_assert(OP % CH == 0, "16-byte aligned operand tiles");
};

// One operand of a product: "rows" (the M index of A, the N index of B) by
// K. K-contiguous (KC): element (r, k) at p[r * ld + k], else at
// p[k * ld + r]. r_lim and k_lim bound what is read; the rest is zeros.
template <typename T>
struct Operand {
  const T* p;
  int64_t ld;
  int r_lim;
  int k_lim;
};

template <typename T, bool KC>
__device__ __forceinline__ void load_tile(SmemT<T>* dst, const Operand<T>& op, int r0, int k0, int tid) {
  using C = Cfg<T>;
  if constexpr (KC) {
    constexpr int KCH = C::BK / C::CH;
    for (int c = tid; c < kBM * KCH; c += kThreads) {
      const int r = r0 + c / KCH, kc = (c % KCH) * C::CH, k = k0 + kc;
      const int n = r < op.r_lim ? max(0, min(C::CH, op.k_lim - k)) : 0;
      cp_async16_zfill(dst + (c / KCH) * C::LDK + kc, n ? op.p + static_cast<int64_t>(r) * op.ld + k : op.p,
                       n * static_cast<int>(sizeof(T)));
    }
  } else {
    constexpr int RCH = kBM / C::CH;
    for (int c = tid; c < C::BK * RCH; c += kThreads) {
      const int k = k0 + c / RCH, rc = (c % RCH) * C::CH, r = r0 + rc;
      const int n = k < op.k_lim ? max(0, min(C::CH, op.r_lim - r)) : 0;
      cp_async16_zfill(dst + (c / RCH) * C::LDR + rc, n ? op.p + static_cast<int64_t>(k) * op.ld + r : op.p,
                       n * static_cast<int>(sizeof(T)));
    }
  }
}

// acc[i][j][2h + e] is the output element at tile row
// wm * 32 + i * 16 + g + 8h and tile column wn * 64 + j * 8 + 2 tig + e
// (the mma.sync accumulator layout; the fp32 path keeps the same one).
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

template <typename T, bool AKC, bool BKC>
__device__ __forceinline__ void compute_stage(float (&acc)[kMT][kNT][4], const SmemT<T>* as, const SmemT<T>* bs,
                                              const Lane& ln) {
  using C = Cfg<T>;
  if constexpr (C::kF32) {
#pragma unroll 4
    for (int k = 0; k < C::BK; ++k) {
      float av[kMT][2], bv[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ln.row(i, h);
          av[i][h] = AKC ? as[r * C::LDK + k] : as[k * C::LDR + r];
        }
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = ln.col(j, e);
          bv[j][e] = BKC ? bs[n * C::LDK + k] : bs[k * C::LDR + n];
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
  } else {
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned a[kMT][4], b[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = ln.wm * kWM + i * 16 + ln.g;
        if constexpr (AKC) {
          const uint16_t* p = as + r * C::LDK + kk + 2 * ln.tig;
          a[i][0] = lds32(p);
          a[i][1] = lds32(p + 8 * C::LDK);
          a[i][2] = lds32(p + 8);
          a[i][3] = lds32(p + 8 * C::LDK + 8);
        } else {
          const uint16_t* p = as + (kk + 2 * ln.tig) * C::LDR + r;
          a[i][0] = pack2(p, C::LDR);
          a[i][1] = pack2(p + 8, C::LDR);
          a[i][2] = pack2(p + 8 * C::LDR, C::LDR);
          a[i][3] = pack2(p + 8 * C::LDR + 8, C::LDR);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = ln.wn * kWN + j * 8 + ln.g;
        if constexpr (BKC) {
          const uint16_t* p = bs + n * C::LDK + kk + 2 * ln.tig;
          b[j][0] = lds32(p);
          b[j][1] = lds32(p + 8);
        } else {
          const uint16_t* p = bs + (kk + 2 * ln.tig) * C::LDR + n;
          b[j][0] = pack2(p, C::LDR);
          b[j][1] = pack2(p + 8 * C::LDR, C::LDR);
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_16816<T>(acc[i][j], a[i], b[j]);
    }
  }
}

// acc = A[m0:m0+128, 0:K] B[n0:n0+128, 0:K]^T over the cp.async ring in
// `smem`. Ends with every copy landed and every thread past its last read.
template <typename T, bool AKC, bool BKC>
__device__ void tile_product(float (&acc)[kMT][kNT][4], SmemT<T>* smem, const Operand<T>& A, const Operand<T>& B,
                             int m0, int n0, int K, const Lane& ln) {
  using C = Cfg<T>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int k_tiles = (K + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      load_tile<T, AKC>(smem + s * C::STAGE, A, m0, s * C::BK, tid);
      load_tile<T, BKC>(smem + s * C::STAGE + C::OP, B, n0, s * C::BK, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed
    __syncthreads();               // ... for every thread, and tile kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      SmemT<T>* st = smem + (next % kStages) * C::STAGE;
      load_tile<T, AKC>(st, A, m0, next * C::BK, tid);
      load_tile<T, BKC>(st + C::OP, B, n0, next * C::BK, tid);
    }
    cp_async_commit();
    const SmemT<T>* st = smem + (kt % kStages) * C::STAGE;
    compute_stage<T, AKC, BKC>(acc, st, st + C::OP, ln);
  }
  cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float capped(float z, float softcap) {
  return softcap > 0.0f ? tanhf(z / softcap) * softcap : z;
}

// merge two online (max, sum) pairs
__device__ __forceinline__ void merge_ms(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

// (a) statistics: block (row tile, split) walks vocab tiles
// [split * per_split, min(vtiles, (split + 1) * per_split)) and writes
// part[q][split][row] for q = max, sum, target logit, zsum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flce_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ target,
                  float* __restrict__ part, int N, int H, int V, int per_split, int splits, float softcap) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  __shared__ float red[kWarpsN][kBM][4];
  SmemT<T>* smem = reinterpret_cast<SmemT<T>*>(flce_smem_raw);
  const Lane ln;
  const int m0 = blockIdx.x * kBM, split = blockIdx.y;
  const int vtiles = (V + kBN - 1) / kBN;
  const int vt_lo = split * per_split, vt_hi = min(vtiles, vt_lo + per_split);
  const Operand<T> A{x, H, N, H}, B{w, H, V, H};

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
    tile_product<T, true, true>(acc, smem, A, B, m0, n0, H, ln);
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

// (b) dz for rows [r0, r0 + rows): block (row tile, vocab tile)
template <typename T>
__global__ void __launch_bounds__(kThreads)
flce_dz_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ target,
               const float* __restrict__ lse, const float* __restrict__ a, const float* __restrict__ c,
               T* __restrict__ dz, int r0, int rows, int H, int V, int ldz, float softcap, float smoothing) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  SmemT<T>* smem = reinterpret_cast<SmemT<T>*>(flce_smem_raw);
  const Lane ln;
  const int m0 = r0 + blockIdx.x * kBM, n0 = blockIdx.y * kBN, r_end = r0 + rows;
  const Operand<T> A{x, H, r_end, H}, B{w, H, V, H};
  float acc[kMT][kNT][4];
  tile_product<T, true, true>(acc, smem, A, B, m0, n0, H, ln);
  const float spread = smoothing / static_cast<float>(V);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + ln.row(i, h);
      if (r >= r_end) continue;
      const float l = lse[r], ar = a[r], cr = c[r];
      const int t = target[r];
      T* out = dz + static_cast<int64_t>(r - r0) * ldz;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = n0 + ln.col(j, e);
          if (v >= V) continue;
          const float zc = capped(acc[i][j][2 * h + e], softcap);
          float d = expf(zc - l) * ar - cr * ((v == t ? 1.0f - smoothing : 0.0f) + spread);
          if (softcap > 0.0f) {
            const float u = zc / softcap;
            d *= 1.0f - u * u;
          }
          out[v] = mojo_from_float<T>(d);
        }
    }
}

// (c) out[m, n] = sum_k A[m, k] B[n, k]; mode 0 stores T, 1 stores the fp32
// buffer, 2 adds into it, 3 stores T(buffer + acc)
template <typename T, bool AKC, bool BKC>
__global__ void __launch_bounds__(kThreads)
flce_gemm_kernel(Operand<T> A, Operand<T> B, T* __restrict__ out, float* __restrict__ buf, int M, int N, int K,
                 int mode) {
  extern __shared__ __align__(16) unsigned char flce_smem_raw[];
  SmemT<T>* smem = reinterpret_cast<SmemT<T>*>(flce_smem_raw);
  const Lane ln;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  float acc[kMT][kNT][4];
  tile_product<T, AKC, BKC>(acc, smem, A, B, m0, n0, K, ln);
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
            out[at] = mojo_from_float<T>(v);
          } else if (mode == 1) {
            buf[at] = v;
          } else if (mode == 2) {
            buf[at] += v;
          } else {
            out[at] = mojo_from_float<T>(buf[at] + v);
          }
        }
    }
}

template <typename KernelFn>
cudaError_t allow_smem(KernelFn* kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T>
int launch_stats(const T* x, const T* w, const int* target, float* part, float* lse, float* tl, float* zs, int N,
                 int H, int V, int max_splits, float softcap, cudaStream_t s) {
  constexpr int smem = Cfg<T>::SMEM;
  static const cudaError_t attr = allow_smem(flce_stats_kernel<T>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int slots = [] {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flce_stats_kernel<T>, kThreads, smem);
    return max(per_sm, 1) * sms;
  }();
  const int row_tiles = (N + kBM - 1) / kBM, vtiles = (V + kBN - 1) / kBN;
  // one wave: as many splits as fill the card's block slots
  int splits = max(1, slots / row_tiles);
  splits = min(splits, min(vtiles, max_splits));
  const int per_split = (vtiles + splits - 1) / splits;
  splits = (vtiles + per_split - 1) / per_split;  // no empty split
  flce_stats_kernel<T><<<dim3(row_tiles, splits), kThreads, smem, s>>>(x, w, target, part, N, H, V, per_split,
                                                                      splits, softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flce_stats_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part, lse, tl, zs, N, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dz(const T* x, const T* w, const int* target, const float* lse, const float* a, const float* c, T* dz,
              int r0, int rows, int H, int V, int ldz, float softcap, float smoothing, cudaStream_t s) {
  constexpr int smem = Cfg<T>::SMEM;
  static const cudaError_t attr = allow_smem(flce_dz_kernel<T>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((rows + kBM - 1) / kBM, (V + kBN - 1) / kBN);
  flce_dz_kernel<T><<<grid, kThreads, smem, s>>>(x, w, target, lse, a, c, dz, r0, rows, H, V, ldz, softcap,
                                                  smoothing);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool AKC, bool BKC>
int launch_gemm(const Operand<T>& A, const Operand<T>& B, T* out, float* buf, int M, int N, int K, int mode,
                cudaStream_t s) {
  constexpr int smem = Cfg<T>::SMEM;
  static const cudaError_t attr = allow_smem(flce_gemm_kernel<T, AKC, BKC>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  flce_gemm_kernel<T, AKC, BKC><<<grid, kThreads, smem, s>>>(A, B, out, buf, M, N, K, mode);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
bool rows_ok(int H) { return H % Cfg<T>::CH == 0; }

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (!rows_ok<T>(H)) return static_cast<int>(cudaErrorInvalidValue);
    rc = launch_stats<T>(static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(target),
                         static_cast<float*>(part), static_cast<float*>(lse), static_cast<float*>(tl),
                         static_cast<float*>(zs), N, H, V, max_splits, softcap, s);
  });
  return rc;
}

// dz (rows, ldz) for rows [r0, r0 + rows) of x, target, lse, a and c (the
// full arrays); ldz % 8 == 0 and ldz >= V.
extern "C" int mojo_flce_dz(const void* x, const void* w, const void* target, const void* lse, const void* a,
                            const void* c, void* dz, int r0, int rows, int H, int V, int ldz, float softcap,
                            float label_smoothing, int dtype, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || H <= 0 || ldz < V || !aligned16(x) || !aligned16(w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (!rows_ok<T>(H)) return static_cast<int>(cudaErrorInvalidValue);
    rc = launch_dz<T>(static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const int*>(target),
                      static_cast<const float*>(lse), static_cast<const float*>(a), static_cast<const float*>(c),
                      static_cast<T*>(dz), r0, rows, H, V, ldz, softcap, label_smoothing, s);
  });
  return rc;
}

// dx (rows, H) = dz (rows, V; row pitch ldz) w (V, H)
extern "C" int mojo_flce_dx(const void* dz, const void* w, void* dx, int rows, int H, int V, int ldz, int dtype,
                            void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (V <= 0 || H <= 0 || ldz < V || !aligned16(dz) || !aligned16(w)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (!rows_ok<T>(H) || !rows_ok<T>(ldz)) return static_cast<int>(cudaErrorInvalidValue);
    const Operand<T> A{static_cast<const T*>(dz), ldz, rows, V}, B{static_cast<const T*>(w), H, H, V};
    rc = launch_gemm<T, true, false>(A, B, static_cast<T*>(dx), nullptr, rows, H, V, 0, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (!rows_ok<T>(H) || !rows_ok<T>(ldz)) return static_cast<int>(cudaErrorInvalidValue);
    const Operand<T> A{static_cast<const T*>(dz), ldz, V, rows}, B{static_cast<const T*>(x), H, H, rows};
    rc = launch_gemm<T, false, false>(A, B, static_cast<T*>(dw), static_cast<float*>(buf), V, H, rows, mode, s);
  });
  return rc;
}
