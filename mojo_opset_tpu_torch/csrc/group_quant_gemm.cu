// Kernel R: int8 / packed-int4 grouped scaled GEMM, the quantized MoE experts' two products.
//
// Replaces no Pallas kernel: the JAX package computes these products with XLA's ragged_dot on int8 with int32
// sums (backends/xla/operators/moe.py:51, XlaQuantExperts._ragged_quant_linear), and PyTorch has no exact int8
// grouped product (torch._int_mm takes one matrix, torch._grouped_mm no int8, and an fp32 product of int8 values
// rounds once |sum| passes 2^24).
//
// out[r, n] = float(sum_k x[r, k] * W[g(r), n, k]) * ws[g(r), n] * xs[r], multiplied in that order in fp32 (the
// golden's, JAX core/operators/moe.py:258) and rounded once to the output dtype, so the kernel equals its plain
// version bit for bit. x int8 (M, K) with its rows sorted by group; group_sizes (G,) int32 on the device, g(r)
// the group of row r; W int8 (G, N, K), or packed int4 (G, N / 2, K) whose packed row r holds output rows 2r
// (low nibble) and 2r + 1 (high nibble); ws fp32 (G, N); xs fp32 (M). The sums are exact in int32. Rows past
// the groups' end are written as zeros; a group that runs past row M is cut there.
//
// Bound on the H100: the active experts' weight slabs. At decode (32 rows over at most 32 of 128 or 256
// experts) each active slab is read once and the arithmetic is tiny; at prefill (about 50-100 rows an expert)
// the bytes still bound it (DeepSeek-V3's fc1: 775 G int8 operations take 0.39 ms at the dense peak, its 7.5 GB
// of slabs 2.24 ms), so an expert with no rows costs no weight bytes and each n tile of an active slab streams
// from HBM once.
//
// Design. Kernel H's row tiles (group_tiles.cuh): a row tile belongs to one group and starts at its first row
// or BM rows after; each block finds its tile from the counts on the device, the grid is sized by the static
// bound min(ceil(M / BM) + G, M), and the surplus blocks zero the rows past the groups' end. The n tile is
// blockIdx.x, the fastest over blocks, so the blocks in flight share a row tile (an expert's x rows stay in
// L2) and walk one slab. The tiles are kernel F's decode kind: mma.sync.m16n8k32 s8 with int32 accumulators fed
// by a 4-stage cp.async ring, (N, K) fragments read with 32-bit shared loads from rows padded by 16 bytes (the
// 32 lanes hit 32 banks). Three tiles, which the wrapper chooses from shapes (group_quant_gemm.route):
//   decode (M < 32 G, few rows a group): 16 x 32 output tiles, 4 warps of 16 x 8, 128-byte k stages;
//   prefill (32 G <= M < 96 G): 64 x 128 output tiles, 8 warps of 32 x 32, 64-byte k stages, so a typical
//     expert's rows are one or two row tiles and its slab's n tiles are read once or twice, the second time
//     from L2;
//   tall prefill (M >= 96 G): 128 x 128 output tiles, 8 warps of 64 x 32, 64-byte k stages: an expert of about
//     100 rows is one row tile, its slab's n tiles read once, and a warp's fragments feed 16 products a k step.
// Packed int4 is a template form of all three: a stage holds BN / 2 packed rows, and a B fragment's 4 bytes become 16
// x the weights of their low or high nibble (nib16_lo / nib16_hi, int_wgmma.cuh), so the int32 sums are 16 x
// the int4 ones and are shifted right by 4 before the epilogue. Every block sums in a fixed order with no
// atomics: results repeat bit for bit.
#include "group_tiles.cuh"
#include "int_wgmma.cuh"

namespace {

// route codes shared with backends/cuda/kernels/group_quant_gemm.py
enum GroupQuantRoute : int { kRouteDecode = 0, kRoutePrefill = 1, kRouteTall = 2 };

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, bool INT4_>
struct GqTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr bool INT4 = INT4_;
  static constexpr int STAGES = 4;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles per warp
  static constexpr int LD = BK + 16;                          // padded row bytes of A and B
  static constexpr int B_ROWS = INT4 ? BN / 2 : BN;           // weight rows a stage: packed rows for int4
  static constexpr int A_BYTES = BM * LD, B_BYTES = B_ROWS * LD;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static constexpr int SHIFT = INT4 ? 4 : 0;  // the int4 sums are 16 x the weights'
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 32 == 0 && BN % 2 == 0, "mma tile shapes");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte aligned stages");
};

template <bool INT4>
using DecodeTile = GqTile<16, 32, 128, 1, 4, INT4>;
template <bool INT4>
using PrefillTile = GqTile<64, 128, 64, 2, 4, INT4>;
template <bool INT4>
using TallTile = GqTile<128, 128, 64, 2, 4, INT4>;

__device__ __forceinline__ uint32_t lds32u(const unsigned char* p) { return *reinterpret_cast<const uint32_t*>(p); }

template <typename TO, typename C>
__global__ void __launch_bounds__(C::THREADS)
group_quant_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const int* __restrict__ group_sizes, const float* __restrict__ xs,
                        const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int K, int G) {
  extern __shared__ __align__(16) unsigned char mojo_gq_smem[];
  __shared__ TileInfo info;
  __shared__ int scratch[C::THREADS / 32];
  const int t = blockIdx.y, n0 = blockIdx.x * C::BN;
  locate_tile<C::THREADS, C::BM>(group_sizes, G, M, t, info, scratch);
  if (info.kind == 0) {
    // a surplus block zeroes its share of the rows past the groups' end: tail tile t - tiles, then every
    // (gridDim.y - tiles)-th after it (there is at least one surplus block whenever such rows exist)
    const int surplus = static_cast<int>(gridDim.y) - info.tiles;
    for (int r0 = info.filled + (t - info.tiles) * C::BM; r0 < M; r0 += surplus * C::BM) {
      for (int i = threadIdx.x; i < C::BM * C::BN; i += C::THREADS) {
        const int r = r0 + i / C::BN, n = n0 + i % C::BN;
        if (r < M && n < N) out[static_cast<int64_t>(r) * N + n] = mojo_from_float<TO>(0.0f);
      }
    }
    return;
  }
  const int row_lo = info.row_lo, row_hi = info.row_hi;
  const int w_rows = C::INT4 ? N / 2 : N;   // rows of a slab
  const int w_row0 = C::INT4 ? n0 / 2 : n0;  // this n tile's first slab row
  const int8_t* wg = w + static_cast<int64_t>(info.group) * w_rows * K;
  const float* wsg = ws + static_cast<int64_t>(info.group) * N;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int k_tiles = (K + C::BK - 1) / C::BK;

  auto load_tile = [&](int stage, int kt) {
    unsigned char* as = mojo_gq_smem + stage * C::STAGE_BYTES;
    unsigned char* bs = as + C::A_BYTES;
    const int k0 = kt * C::BK;
    constexpr int KCH = C::BK / 16;  // 16-byte chunks per k-row
    for (int c = tid; c < C::BM * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = row_lo + r < row_hi && k < K;
      cp_async16(as + r * C::LD + (c % KCH) * 16, ok ? x + static_cast<int64_t>(row_lo + r) * K + k : x, ok);
    }
    for (int c = tid; c < C::B_ROWS * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = w_row0 + r < w_rows && k < K;
      cp_async16(bs + r * C::LD + (c % KCH) * 16, ok ? wg + static_cast<int64_t>(w_row0 + r) * K + k : wg, ok);
    }
  };

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

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

    const unsigned char* as = mojo_gq_smem + (kt % C::STAGES) * C::STAGE_BYTES;
    const unsigned char* bs = as + C::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 32) {
      int a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const unsigned char* p = as + (wm * C::WM + i * 16 + g) * C::LD + kk + tig * 4;
        a[i][0] = static_cast<int>(lds32u(p));
        a[i][1] = static_cast<int>(lds32u(p + 8 * C::LD));
        a[i][2] = static_cast<int>(lds32u(p + 16));
        a[i][3] = static_cast<int>(lds32u(p + 8 * C::LD + 16));
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int n = wn * C::WN + j * 8 + g;  // the tile's column of this lane's fragment
        if constexpr (C::INT4) {
          // column n is packed row n / 2 of the stage (n0 is even), its low nibble for even n
          const unsigned char* p = bs + (n >> 1) * C::LD + kk + tig * 4;
          const uint32_t u0 = lds32u(p), u1 = lds32u(p + 16);
          b[j][0] = (n & 1) ? nib16_hi(u0) : nib16_lo(u0);
          b[j][1] = (n & 1) ? nib16_hi(u1) : nib16_lo(u1);
        } else {
          const unsigned char* p = bs + n * C::LD + kk + tig * 4;
          b[j][0] = static_cast<int>(lds32u(p));
          b[j][1] = static_cast<int>(lds32u(p + 16));
        }
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // the epilogue in the golden's order: (float(sum) * ws) * xs, one rounding to TO
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_lo + wm * C::WM + i * 16 + g + 8 * h;
      if (m >= row_hi) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * C::WN + j * 8 + tig * 2 + e;
          if (n < N) {
            const float v = static_cast<float>(acc[i][j][2 * h + e] >> C::SHIFT) * wsg[n];
            out[static_cast<int64_t>(m) * N + n] = mojo_from_float<TO>(v * sx);
          }
        }
      }
    }
  }
}

template <typename TO, typename C>
int launch(const int8_t* x, const int8_t* w, const int* gs, const float* xs, const float* ws, TO* out, int M, int N,
           int K, int G, cudaStream_t stream) {
  const int tiles = row_tiles(M, G, C::BM);
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);  // the row tiles are gridDim.y
  static const cudaError_t attr = cudaFuncSetAttribute(
      group_quant_gemm_kernel<TO, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + C::BN - 1) / C::BN, tiles);
  group_quant_gemm_kernel<TO, C><<<grid, C::THREADS, C::SMEM, stream>>>(x, w, gs, xs, ws, out, M, N, K, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int dispatch_route(int route, bool int4, const int8_t* x, const int8_t* w, const int* gs, const float* xs,
                   const float* ws, TO* out, int M, int N, int K, int G, cudaStream_t s) {
  switch (route) {
    case kRouteDecode:
      return int4 ? launch<TO, DecodeTile<true>>(x, w, gs, xs, ws, out, M, N, K, G, s)
                  : launch<TO, DecodeTile<false>>(x, w, gs, xs, ws, out, M, N, K, G, s);
    case kRoutePrefill:
      return int4 ? launch<TO, PrefillTile<true>>(x, w, gs, xs, ws, out, M, N, K, G, s)
                  : launch<TO, PrefillTile<false>>(x, w, gs, xs, ws, out, M, N, K, G, s);
    case kRouteTall:
      return int4 ? launch<TO, TallTile<true>>(x, w, gs, xs, ws, out, M, N, K, G, s)
                  : launch<TO, TallTile<false>>(x, w, gs, xs, ws, out, M, N, K, G, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (M, K) int8, rows sorted by group; w: (G, N, K) int8, or with int4 (G, N / 2, K) packed; group_sizes: (G,)
// int32; xs: (M,) fp32; ws: (G, N) fp32; out: (M, N) in `dtype`. All contiguous and 16-byte aligned; K % 16 == 0
// (every 16-byte copy inside one row), and for int4 N even and K <= kMaxPackedK. `route` as the wrapper chose it
// (group_quant_gemm.route).
extern "C" int mojo_group_quant_gemm(const void* x, const void* w, const void* group_sizes, const void* xs,
                                     const void* ws, void* out, int M, int N, int K, int G, int int4, int route,
                                     int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (G <= 0 || K <= 0 || K % 16 != 0 || (int4 && (N % 2 != 0 || K > kMaxPackedK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    rc = dispatch_route<TO>(route, int4 != 0, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                            static_cast<const int*>(group_sizes), static_cast<const float*>(xs),
                            static_cast<const float*>(ws), static_cast<TO*>(out), M, N, K, G, s);
  });
  return rc;
}
