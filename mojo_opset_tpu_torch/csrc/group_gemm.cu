// Kernel H: ragged grouped GEMM, the MoE experts' two products.
//
// Replaces the JAX package's backends/pallas/kernels/group_gemm.py:220
// (grouped_matmul, body _gmm_kernel_innerk :40, call :308).
//
// out[r] = x[r] @ W[group_of(r)]: x (M, K) with its rows sorted by group,
// group_sizes (G,) int32 on the device, W (G, K, N), or (G, N, K) when
// trans_weight (the experts' stored layout). fp32 sums, one rounding to
// the input dtype. Rows past the groups' end are written as zeros; a group
// that runs past row M is cut there.
//
// Bound on the H100: the expert weights. At decode (M = 8 x batch rows over
// up to 8 x batch experts) each active expert's slab is read once per
// n tile and the arithmetic is tiny; at prefill (~100 rows per expert at
// Qwen3-30B-A3B) the work still sits below the card's ridge point, so the
// bytes of all experts bound it too.
//
// Design. Each block owns one (group, row tile, n tile) and masks its own
// ragged rows: no 8-aligned overlapping windows, no read-merge-write of
// boundary rows and no reliance on grid order, which the TPU kernel needs
// because Mosaic DMAs want 8-aligned sublane offsets and its grid runs in
// order on one core. The grid is sized by a static bound, min(ceil(M / BM)
// + G, M) row tiles (every tile holds at least one row), so the host never
// reads the counts: each block scans the counts in shared memory, finds its
// group and row range, and surplus blocks zero the rows past the groups'
// end or exit. bf16 and fp16 run on tensor cores (mma.sync.m16n8k16, fp32
// accumulators) fed from shared memory that cp.async fills 16 bytes at a
// time in a ring of k tiles, as kernel F does. The stored (N, K) weight is
// K-contiguous, the "col" B operand of the instruction, so its fragments
// are 32-bit shared loads; a (K, N) weight gathers two 16-bit values per
// fragment word. Two tile shapes: 16 x 64 (4 warps along N) when the rows
// per group are few (decode), so one row tile covers an expert's tokens and
// reads its slab once per n tile, and 128 x 128 (8 warps of 32 x 64)
// otherwise (prefill). fp32 inputs (small test models) take a shared-memory
// FMA kernel in the same source. No split-K, TMA or wgmma yet.
#include "common.cuh"

namespace {

// Block-wide exclusive prefix sum of one int per thread; `total` gets the
// sum over the block. `scratch` holds THREADS / 32 ints of shared memory.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    const int s = scratch[i];
    if (i < warp) before += s;
    total += s;
  }
  __syncthreads();  // scratch is reused by the next scan
  return before + incl - v;
}

struct TileInfo {
  int kind;    // 1: a group's row tile, 0: a surplus block
  int group;
  int row_lo;  // rows [row_lo, row_hi) of this tile
  int row_hi;
  int tiles;   // row tiles of all groups
  int filled;  // rows covered by the groups (<= M)
};

// Find row tile `t` of the groups from the counts on the device.
template <int THREADS, int BM>
__device__ void locate_tile(const int* __restrict__ group_sizes, int G, int M, int t, TileInfo& info,
                            int* scratch) {
  if (threadIdx.x == 0) info.kind = 0;
  __syncthreads();
  int row_carry = 0, tile_carry = 0;
  for (int base = 0; base < G; base += THREADS) {
    const int g = base + static_cast<int>(threadIdx.x);
    const int c = g < G ? max(group_sizes[g], 0) : 0;
    int chunk_rows, chunk_tiles;
    const int row_start = row_carry + block_exclusive_scan<THREADS>(c, scratch, chunk_rows);
    const int rows = max(0, min(c, M - row_start));
    const int tiles = (rows + BM - 1) / BM;
    const int tile_start = tile_carry + block_exclusive_scan<THREADS>(tiles, scratch, chunk_tiles);
    if (t >= tile_start && t < tile_start + tiles) {
      const int lo = row_start + (t - tile_start) * BM;
      info.kind = 1;
      info.group = g;
      info.row_lo = lo;
      info.row_hi = min(lo + BM, row_start + rows);
    }
    row_carry = min(row_carry + chunk_rows, M);
    tile_carry += chunk_tiles;
  }
  if (threadIdx.x == 0) {
    info.tiles = tile_carry;
    info.filled = row_carry;
  }
  __syncthreads();
}

// A surplus block zeroes its share of the rows past the groups' end: tail
// tile u = t - tiles, then every (gridDim.x - tiles)-th after it. There is
// at least one surplus block whenever such rows exist (module note).
template <typename T, int BM, int BN, int THREADS>
__device__ void zero_tail(const TileInfo& info, T* __restrict__ out, int M, int N, int t, int n0) {
  const int surplus = static_cast<int>(gridDim.x) - info.tiles;
  for (int r0 = info.filled + (t - info.tiles) * BM; r0 < M; r0 += surplus * BM) {
    for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
      const int r = r0 + i / BN, n = n0 + i % BN;
      if (r < M && n < N) out[static_cast<int64_t>(r) * N + n] = mojo_from_float<T>(0.0f);
    }
  }
}

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct GmmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles per warp
  static constexpr int LDK = BK + 8;                          // padded row (elements) of A and of an (N, K) B
  static constexpr int LDN = BN + 8;                          // padded row (elements) of a (K, N) B
  static constexpr int A_ELEMS = BM * LDK;
  static constexpr int B_ELEMS = (BN * LDK > BK * LDN) ? BN * LDK : BK * LDN;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;  // bytes of 16-bit elements
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 16 == 0, "mma tile shapes");
  static_assert(A_ELEMS % 8 == 0 && B_ELEMS % 8 == 0, "16-byte aligned stages");
};

using DecodeTile = GmmTile<16, 64, 64, 1, 4, 4>;
using PrefillTile = GmmTile<128, 128, 32, 4, 2, 3>;

template <typename T, typename C, bool TRANS>
__global__ void __launch_bounds__(C::THREADS)
gmm_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ group_sizes,
               T* __restrict__ out, int M, int N, int K, int G) {
  extern __shared__ __align__(16) unsigned char mojo_gmm_smem[];
  __shared__ TileInfo info;
  __shared__ int scratch[C::THREADS / 32];
  const int t = blockIdx.x, n0 = blockIdx.y * C::BN;
  locate_tile<C::THREADS, C::BM>(group_sizes, G, M, t, info, scratch);
  if (info.kind == 0) {
    zero_tail<T, C::BM, C::BN, C::THREADS>(info, out, M, N, t, n0);
    return;
  }
  const int row_lo = info.row_lo, row_hi = info.row_hi;
  const T* wg = w + static_cast<int64_t>(info.group) * N * K;

  uint16_t* smem = reinterpret_cast<uint16_t*>(mojo_gmm_smem);
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int k_tiles = (K + C::BK - 1) / C::BK;

  auto load_tile = [&](int stage, int kt) {
    uint16_t* as = smem + stage * C::STAGE_ELEMS;
    uint16_t* bs = as + C::A_ELEMS;
    const int k0 = kt * C::BK;
    constexpr int KCH = C::BK / 8;  // 16-byte chunks per k row
    for (int c = tid; c < C::BM * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 8;
      const bool ok = row_lo + r < row_hi && k < K;
      cp_async16(as + r * C::LDK + (c % KCH) * 8, ok ? x + static_cast<int64_t>(row_lo + r) * K + k : x, ok);
    }
    if constexpr (TRANS) {
      for (int c = tid; c < C::BN * KCH; c += C::THREADS) {
        const int r = c / KCH, k = k0 + (c % KCH) * 8;
        const bool ok = n0 + r < N && k < K;
        cp_async16(bs + r * C::LDK + (c % KCH) * 8, ok ? wg + static_cast<int64_t>(n0 + r) * K + k : wg, ok);
      }
    } else {
      constexpr int NCH = C::BN / 8;
      for (int c = tid; c < C::BK * NCH; c += C::THREADS) {
        const int r = c / NCH, n = n0 + (c % NCH) * 8;
        const bool ok = k0 + r < K && n < N;
        cp_async16(bs + r * C::LDN + (c % NCH) * 8, ok ? wg + static_cast<int64_t>(k0 + r) * N + n : wg, ok);
      }
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread, and tile kt-1 is consumed
    const int next = kt + C::STAGES - 1;
    if (next < k_tiles) load_tile(next % C::STAGES, next);
    cp_async_commit();

    const uint16_t* as = smem + (kt % C::STAGES) * C::STAGE_ELEMS;
    const uint16_t* bs = as + C::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const uint16_t* p = as + (wm * C::WM + i * 16 + g) * C::LDK + kk + tig * 2;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * C::LDK);
        a[i][2] = lds32(p + 8);
        a[i][3] = lds32(p + 8 * C::LDK + 8);
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int n = wn * C::WN + j * 8 + g;
        if constexpr (TRANS) {
          const uint16_t* p = bs + n * C::LDK + kk + tig * 2;
          b[j][0] = lds32(p);
          b[j][1] = lds32(p + 8);
        } else {
          const uint16_t* p = bs + (kk + tig * 2) * C::LDN + n;
          b[j][0] = pack2(p, C::LDN);
          b[j][1] = pack2(p + 8 * C::LDN, C::LDN);
        }
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_16816<T>(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_lo + wm * C::WM + i * 16 + g + 8 * h;
      if (m >= row_hi) continue;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * C::WN + j * 8 + tig * 2 + e;
          if (n < N) out[static_cast<int64_t>(m) * N + n] = mojo_from_float<T>(acc[i][j][2 * h + e]);
        }
      }
    }
  }
}

// fp32: 32 x 64 output tiles, 256 threads of 2 x 4 outputs, 16-deep k
// tiles staged through shared memory, FMA in k order.
constexpr int F_BM = 32, F_BN = 64, F_BK = 16, F_THREADS = 256;

template <bool TRANS>
__global__ void __launch_bounds__(F_THREADS)
gmm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w, const int* __restrict__ group_sizes,
               float* __restrict__ out, int M, int N, int K, int G) {
  __shared__ TileInfo info;
  __shared__ int scratch[F_THREADS / 32];
  __shared__ float as[F_BK][F_BM + 1];
  __shared__ float bs[F_BK][F_BN + 1];
  const int t = blockIdx.x, n0 = blockIdx.y * F_BN;
  locate_tile<F_THREADS, F_BM>(group_sizes, G, M, t, info, scratch);
  if (info.kind == 0) {
    zero_tail<float, F_BM, F_BN, F_THREADS>(info, out, M, N, t, n0);
    return;
  }
  const int row_lo = info.row_lo, row_hi = info.row_hi;
  const float* wg = w + static_cast<int64_t>(info.group) * N * K;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += F_BK) {
    for (int i = tid; i < F_BM * F_BK; i += F_THREADS) {  // k fastest: coalesced rows of x
      const int r = i / F_BK, k = i % F_BK;
      as[k][r] = (row_lo + r < row_hi && k0 + k < K) ? x[static_cast<int64_t>(row_lo + r) * K + k0 + k] : 0.0f;
    }
    for (int i = tid; i < F_BN * F_BK; i += F_THREADS) {
      int n, k;
      if constexpr (TRANS) {
        n = i / F_BK, k = i % F_BK;
      } else {
        k = i / F_BN, n = i % F_BN;
      }
      const bool ok = n0 + n < N && k0 + k < K;
      const int64_t off = TRANS ? static_cast<int64_t>(n0 + n) * K + k0 + k : static_cast<int64_t>(k0 + k) * N + n0 + n;
      bs[k][n] = ok ? wg[off] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F_BK; ++k) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(as[k][ty + 16 * r], bs[k][tx + 16 * c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = row_lo + ty + 16 * r;
    if (m >= row_hi) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < N) out[static_cast<int64_t>(m) * N + n] = acc[r][c];
    }
  }
}

inline int row_tiles(int M, int G, int bm) {
  // every tile holds at least one row, and no group wastes more than one tile
  const int64_t bound = static_cast<int64_t>((M + bm - 1) / bm) + G;
  return static_cast<int>(bound < M ? bound : M);
}

template <typename T, typename C, bool TRANS>
int launch_mma(const T* x, const T* w, const int* gs, T* out, int M, int N, int K, int G, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_mma_kernel<T, C, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(row_tiles(M, G, C::BM), (N + C::BN - 1) / C::BN);
  gmm_mma_kernel<T, C, TRANS><<<grid, C::THREADS, C::SMEM, stream>>>(x, w, gs, out, M, N, K, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TRANS>
int dispatch_tile(const T* x, const T* w, const int* gs, T* out, int M, int N, int K, int G, cudaStream_t s) {
  // few rows per group (decode): one 16-row tile covers an expert's tokens
  if (M < 32 * G) return launch_mma<T, DecodeTile, TRANS>(x, w, gs, out, M, N, K, G, s);
  return launch_mma<T, PrefillTile, TRANS>(x, w, gs, out, M, N, K, G, s);
}

}  // namespace

// x: (M, K); w: (G, N, K) when trans_weight, else (G, K, N); group_sizes:
// (G,) int32; out: (M, N). x, w and out share `dtype`; all contiguous and
// 16-byte aligned. For 16-bit types K % 8 == 0, and N % 8 == 0 for a (G, K, N) w.
extern "C" int mojo_group_gemm(const void* x, const void* w, const void* group_sizes, void* out, int M, int N,
                               int K, int G, int trans_weight, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (G <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == kMojoF32) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    const dim3 grid(row_tiles(M, G, F_BM), (N + F_BN - 1) / F_BN);
    if (trans_weight) {
      gmm_fma_kernel<true><<<grid, F_THREADS, 0, s>>>(xf, wf, gs, of, M, N, K, G);
    } else {
      gmm_fma_kernel<false><<<grid, F_THREADS, 0, s>>>(xf, wf, gs, of, M, N, K, G);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (K % 8 != 0 || (!trans_weight && N % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kMojoF16: {
      const __half* xh = static_cast<const __half*>(x);
      const __half* wh = static_cast<const __half*>(w);
      __half* oh = static_cast<__half*>(out);
      rc = trans_weight ? dispatch_tile<__half, true>(xh, wh, gs, oh, M, N, K, G, s)
                        : dispatch_tile<__half, false>(xh, wh, gs, oh, M, N, K, G, s);
      break;
    }
    case kMojoBF16: {
      const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
      const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
      rc = trans_weight ? dispatch_tile<__nv_bfloat16, true>(xb, wb, gs, ob, M, N, K, G, s)
                        : dispatch_tile<__nv_bfloat16, false>(xb, wb, gs, ob, M, N, K, G, s);
      break;
    }
    default:
      break;
  }
  return rc;
}
