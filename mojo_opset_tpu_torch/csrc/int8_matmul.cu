// Kernel F: int8 x int8 -> int32 GEMM with the per-token x per-channel
// dequant epilogue.
//
// Replaces the JAX package's backends/pallas/kernels/int8_matmul.py:54
// (int8_scaled_matmul, body _int8_mm_kernel :30, call :87).
//
// out[m, n] = float(sum_k x[m, k] * w[n, k]) * xs[m] * ws[n], rounded once
// to the output dtype. The int32 sum is exact (|sum| <= K * 128^2); the
// epilogue multiplies in that order, in fp32, as the golden does.
//
// Bound on the H100: at prefill (M = 1650 tokens, ~2e8 int8 ops per token
// and layer at Qwen3-4B) the tensor cores; at decode (M = batch) the bytes
// of the int8 weights, streamed once per step. Three routes, which the
// wrapper picks from shapes and the layout (int8_matmul.route):
//   prefill (M > 16, the (N, K) weight every model stores): Hopper's wgmma
//     m64nNk32 s8 fed by TMA, in the shape of kernels N and H: the
//     persistent producer / two-consumer-warpgroup kernel of int_wgmma.cuh,
//     shared with kernel G. BN is 256, or 128 where 256-wide tiles would
//     leave SMs idle (N = 1024 at M = 1650); units (m tile, n tile) run m
//     fastest, so the blocks in flight share a weight slab; every lane
//     stores 16 contiguous bytes.
//   decode (M <= 16): mma.sync.m16n8k32 on 16 x 32 tiles with 128-deep
//     k-tiles (4 warps of 16 x 8) fed by a 4-stage cp.async ring, so more
//     blocks share out the weight stream; where N / 32 blocks would leave
//     SMs idle the wrapper splits K over gridDim.z. Each split writes its
//     int32 tile to scratch; the last block of a tile to arrive (a counter
//     an output tile, which it returns to 0) sums the splits in order and
//     runs the epilogue once. int32 sums are exact in any order, so the
//     split changes no bit.
//   a (K, N) weight at M > 16 (no model stores one): mma.sync on 128 x 128
//     tiles (8 warps of 64 x 32), as before the wgmma route; its fragments
//     gather 4 bytes each from the tile staged as it lies.
// The mma.sync tiles read (N, K) fragments with 32-bit shared loads from
// rows padded by 16 bytes (the 32 lanes hit 32 banks); ragged M, N and K
// are zero-filled on load and masked on store. K % 16 == 0 (and N % 16 ==
// 0 for a (K, N) weight) keeps every 16-byte copy inside one row and TMA's
// row pitch a multiple of 16. Every route sums in a fixed order: results
// repeat bit for bit.
#include "int_wgmma.cuh"

namespace {

// route codes shared with backends/cuda/kernels/int8_matmul.py
enum Int8Route : int { kRouteLargeMma = 0, kRouteDecodeMma = 1, kRouteWgmma128 = 2, kRouteWgmma256 = 3 };

template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles per warp
  static constexpr int LDA = BK + 16;                         // padded row bytes of A and of an (N, K) B
  static constexpr int LDB_KN = BN + 16;                      // padded row bytes of a (K, N) B
  static constexpr int A_BYTES = BM * LDA;
  static constexpr int B_BYTES = (BN * LDA > BK * LDB_KN) ? BN * LDA : BK * LDB_KN;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
  static_assert(WM % 16 == 0 && WN % 8 == 0 && BK % 32 == 0, "mma tile shapes");
  static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0, "16-byte aligned stages");
};

using LargeTile = GemmTile<128, 128, 64, 2, 4, 4>;
using DecodeTile = GemmTile<16, 32, 128, 1, 4, 4>;

__device__ __forceinline__ int lds32(const unsigned char* p) { return *reinterpret_cast<const int*>(p); }

// 4 bytes of column n from rows k .. k+3 of a (K, N) tile, k in the low byte
__device__ __forceinline__ int gather4(const unsigned char* p, int ld) {
  return static_cast<int>(static_cast<unsigned>(p[0]) | (static_cast<unsigned>(p[ld]) << 8) |
                          (static_cast<unsigned>(p[2 * ld]) << 16) | (static_cast<unsigned>(p[3 * ld]) << 24));
}

// The mma.sync tiles. gridDim.z splits K: split z takes k-tiles [z kt_per_split, (z + 1) kt_per_split). With
// one split the block stores its tile; with more it writes the int32 tile to `part` and the last of the tile's
// blocks to arrive (counted in `arrivals`, zero on entry and returned to zero) sums the splits and stores.
template <typename TO, typename C, bool TRANS>
__global__ void __launch_bounds__(C::THREADS)
int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ xs,
                 const float* __restrict__ ws, TO* __restrict__ out, int* __restrict__ part, int* arrivals, int M,
                 int N, int K, int kt_per_split) {
  extern __shared__ __align__(16) unsigned char mojo_gemm_smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int splits = gridDim.z;
  const int k_tiles = (K + C::BK - 1) / C::BK;
  const int kt0 = blockIdx.z * kt_per_split;
  const int kn = min(kt0 + kt_per_split, k_tiles) - kt0;  // this split's k-tiles

  auto load_tile = [&](int stage, int kt) {
    unsigned char* as = mojo_gemm_smem + stage * C::STAGE_BYTES;
    unsigned char* bs = as + C::A_BYTES;
    const int k0 = kt * C::BK;
    constexpr int KCH = C::BK / 16;  // 16-byte chunks per k-row
    for (int c = tid; c < C::BM * KCH; c += C::THREADS) {
      const int r = c / KCH, k = k0 + (c % KCH) * 16;
      const bool ok = m0 + r < M && k < K;
      cp_async16(as + r * C::LDA + (c % KCH) * 16, ok ? x + static_cast<int64_t>(m0 + r) * K + k : x, ok);
    }
    if constexpr (TRANS) {
      for (int c = tid; c < C::BN * KCH; c += C::THREADS) {
        const int r = c / KCH, k = k0 + (c % KCH) * 16;
        const bool ok = n0 + r < N && k < K;
        cp_async16(bs + r * C::LDA + (c % KCH) * 16, ok ? w + static_cast<int64_t>(n0 + r) * K + k : w, ok);
      }
    } else {
      constexpr int NCH = C::BN / 16;
      for (int c = tid; c < C::BK * NCH; c += C::THREADS) {
        const int r = c / NCH, n = n0 + (c % NCH) * 16;
        const bool ok = k0 + r < K && n < N;
        cp_async16(bs + r * C::LDB_KN + (c % NCH) * 16, ok ? w + static_cast<int64_t>(k0 + r) * N + n : w, ok);
      }
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
    if (s < kn) load_tile(s, kt0 + s);
    cp_async_commit();
  }

  for (int kt = 0; kt < kn; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // tile kt has landed
    __syncthreads();                 // ... for every thread, and tile kt-1 is consumed
    const int next = kt + C::STAGES - 1;
    if (next < kn) load_tile(next % C::STAGES, kt0 + next);
    cp_async_commit();

    const unsigned char* as = mojo_gemm_smem + (kt % C::STAGES) * C::STAGE_BYTES;
    const unsigned char* bs = as + C::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 32) {
      int a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const unsigned char* p = as + (wm * C::WM + i * 16 + g) * C::LDA + kk + tig * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * C::LDA);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * C::LDA + 16);
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int n = wn * C::WN + j * 8 + g;
        if constexpr (TRANS) {
          const unsigned char* p = bs + n * C::LDA + kk + tig * 4;
          b[j][0] = lds32(p);
          b[j][1] = lds32(p + 16);
        } else {
          const unsigned char* p = bs + (kk + tig * 4) * C::LDB_KN + n;
          b[j][0] = gather4(p, C::LDB_KN);
          b[j][1] = gather4(p + 16 * C::LDB_KN, C::LDB_KN);
        }
      }
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::WM + i * 16 + g + 8 * h;
        if (m >= M) continue;
        const float sx = xs[m];
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + wn * C::WN + j * 8 + tig * 2 + e;
            if (n < N) {
              out[static_cast<int64_t>(m) * N + n] = mojo_from_float<TO>(dequant(acc[i][j][2 * h + e], sx, ws[n]));
            }
          }
        }
      }
    }
    return;
  }

  // split K: this split's int32 tile, rows and columns as in the tile
  constexpr int TILE = C::BM * C::BN;
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x, tiles = gridDim.x * gridDim.y;
  int* mine = part + (static_cast<int64_t>(blockIdx.z) * tiles + tile_id) * TILE;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int r = wm * C::WM + i * 16 + g + 8 * h, c = wn * C::WN + j * 8 + tig * 2;
        *reinterpret_cast<int2*>(mine + r * C::BN + c) = make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  __shared__ int is_last;
  __threadfence();  // this block's partials are visible before it is counted
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&arrivals[tile_id], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: the splits' sums in split order, 4 columns a thread, the epilogue once
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  for (int e = tid * 4; e < TILE; e += C::THREADS * 4) {
    const int m = m0 + e / C::BN, n = n0 + e % C::BN;
    if (m >= M || n >= N) continue;
    int4 s = make_int4(0, 0, 0, 0);
    for (int z = 0; z < splits; ++z) {
      const int* tile = part + (static_cast<int64_t>(z) * tiles + tile_id) * TILE;
      const int4 v = __ldcg(reinterpret_cast<const int4*>(tile + e));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float sx = xs[m];
    TO* o = out + static_cast<int64_t>(m) * N + n;
    if (vec) {  // n % 4 == 0 and N % 4 == 0: the 4 columns lie inside the row, 8- or 16-byte aligned
      const float4 sw = *reinterpret_cast<const float4*>(ws + n);
      const float v[4] = {dequant(s.x, sx, sw.x), dequant(s.y, sx, sw.y), dequant(s.z, sx, sw.z),
                          dequant(s.w, sx, sw.w)};
      mojo_store_row<TO, 4>(o, v);
    } else {
      const int v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (n + k < N) o[k] = mojo_from_float<TO>(dequant(v[k], sx, ws[n + k]));
    }
  }
  if (tid == 0) arrivals[tile_id] = 0;  // ready for the next launch (and a CUDA graph's next replay)
}

template <typename TO, typename C, bool TRANS>
int launch_mma(const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out, int* part,
               int* arrivals, int M, int N, int K, int splits, cudaStream_t stream) {
  const int k_tiles = (K + C::BK - 1) / C::BK;
  // every split holds at least one k-tile, and a split launch has its scratch
  if (splits < 1 || (splits > 1 && (k_tiles < splits || part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (k_tiles + splits - 1) / splits;
  if (splits > 1 && (k_tiles + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel<TO, C, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, splits);
  int8_gemm_kernel<TO, C, TRANS><<<grid, C::THREADS, C::SMEM, stream>>>(x, w, xs, ws, out, part, arrivals, M, N, K,
                                                                        per);
  return static_cast<int>(cudaGetLastError());
}

MOJO_INT_WGMMA_KERNEL(int8_wgmma_kernel, false)

template <typename TO>
int dispatch_route(int route, bool trans, const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out,
                   int* part, int* arrivals, int M, int N, int K, int splits, cudaStream_t s) {
  switch (route) {
    case kRouteWgmma128:
    case kRouteWgmma256:
      if (!trans || splits != 1 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
      return route == kRouteWgmma256
                 ? launch_wgmma<TO, 256, false>(int8_wgmma_kernel<TO, 256>, x, w, xs, ws, out, nullptr, nullptr, M, N,
                                                K, 1, s)
                 : launch_wgmma<TO, 128, false>(int8_wgmma_kernel<TO, 128>, x, w, xs, ws, out, nullptr, nullptr, M, N,
                                                K, 1, s);
    case kRouteDecodeMma:
      return trans ? launch_mma<TO, DecodeTile, true>(x, w, xs, ws, out, part, arrivals, M, N, K, splits, s)
                   : launch_mma<TO, DecodeTile, false>(x, w, xs, ws, out, part, arrivals, M, N, K, splits, s);
    case kRouteLargeMma:
      if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
      return trans ? launch_mma<TO, LargeTile, true>(x, w, xs, ws, out, part, arrivals, M, N, K, 1, s)
                   : launch_mma<TO, LargeTile, false>(x, w, xs, ws, out, part, arrivals, M, N, K, 1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (M, K) int8; w: (N, K) int8 when trans_weight, else (K, N); xs: (M,)
// fp32; ws: (N,) fp32; out: (M, N) in `dtype`. All contiguous and 16-byte
// aligned; K % 16 == 0, and N % 16 == 0 when !trans_weight. `route` and
// `splits` as the wrapper chose them (int8_matmul.route): with splits > 1,
// part holds splits x (its tiles) x 512 int32 and arrivals one zeroed int32
// a 16 x 32 output tile.
extern "C" int mojo_int8_matmul(const void* x, const void* w, const void* xs, const void* ws, void* out, void* part,
                                void* arrivals, int M, int N, int K, int trans_weight, int route, int splits,
                                int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (K % 16 != 0 || (!trans_weight && N % 16 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    rc = dispatch_route<TO>(route, trans_weight != 0, xq, wq, xsf, wsf, static_cast<TO*>(out),
                            static_cast<int*>(part), static_cast<int*>(arrivals), M, N, K, splits, s);
  });
  return rc;
}
