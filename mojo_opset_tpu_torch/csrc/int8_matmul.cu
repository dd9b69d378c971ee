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
//     m64nNk32 s8 fed by TMA (hopper.cuh), in the shape of kernels N and
//     H: a persistent grid of one block an SM, three warpgroups; the first
//     thread of the third keeps a ring of TMA loads in flight (128-byte k
//     slices of x's 128 rows and of W's BN rows, in the 128-byte swizzle,
//     a full and an empty mbarrier a stage) and the two consumer
//     warpgroups each own 64 rows of the 128 x BN output tile (int32
//     accumulators in registers, one group in flight while the next stage
//     lands). Both operands are K-major, as 8-bit wgmma requires. BN is
//     256, or 128 where 256-wide tiles would leave SMs idle (N = 1024 at
//     M = 1650); units (m tile, n tile) run m fastest, so the blocks in
//     flight share a weight slab. TMA zero-fills rows past M and N and k
//     past K, and a zero adds nothing to an integer sum: only the store is
//     masked. The epilogue loads ws two columns at a time and swaps
//     values inside each quad of lanes (16-bit output) or pair (fp32) so
//     that every lane stores 16 contiguous bytes.
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
#include "common.cuh"
#include "hopper.cuh"

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

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lds32(const unsigned char* p) { return *reinterpret_cast<const int*>(p); }

// 4 bytes of column n from rows k .. k+3 of a (K, N) tile, k in the low byte
__device__ __forceinline__ int gather4(const unsigned char* p, int ld) {
  return static_cast<int>(static_cast<unsigned>(p[0]) | (static_cast<unsigned>(p[ld]) << 8) |
                          (static_cast<unsigned>(p[2 * ld]) << 16) | (static_cast<unsigned>(p[3 * ld]) << 24));
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw) { return static_cast<float>(acc) * sx * sw; }

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

// -- the prefill route: wgmma fed by TMA ---------------------------------------------

namespace pre {
constexpr int kBM = 128;        // tile rows: two consumer warpgroups of 64
constexpr int kBK = kSw128K8;   // K of a stage: one 128-byte swizzle row of int8
constexpr int kThreads = 384;   // warpgroups 0-1 consume; warpgroup 2's first thread loads
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK;
constexpr int kRingBytes = 192 * 1024;  // 4 stages of a 128 x 256 tile, 6 of a 128 x 128 one

template <int BN>
struct Tile {
  static constexpr int kStageBytes = kABytes + BN * kBK;
  static constexpr int kStages = kRingBytes / kStageBytes;
  // the stages, slack to align them on 1024 bytes, a full and an empty barrier a stage
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};
}  // namespace pre

// d = 64 x BN of the tile's int32 sum, one wgmma k32 step
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 256) {
    wgmma_m64n256k32_s8(d, desc_a, desc_b);
  } else {
    static_assert(BN == 128, "the prefill tile is 128 or 256 wide");
    wgmma_m64n128k32_s8(d, desc_a, desc_b);
  }
}

// Four 32-bit words of each lane of a quad (u[i]: the lane's word of column group i) transposed across the
// quad: afterwards lane q holds, in u[p], the word that lane p held in u[q]. Two exchanges (lanes q ^ 2, then
// q ^ 1); every lane of the warp takes part.
__device__ __forceinline__ void quad_transpose(uint32_t (&u)[4], int q) {
  const bool hi = q & 2, lo = q & 1;
  uint32_t s0 = hi ? u[0] : u[2], s1 = hi ? u[1] : u[3];
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, s0, 2), r1 = __shfl_xor_sync(0xffffffffu, s1, 2);
  if (hi) {
    u[0] = r0;
    u[1] = r1;
  } else {
    u[2] = r0;
    u[3] = r1;
  }
  s0 = lo ? u[0] : u[1];
  s1 = lo ? u[2] : u[3];
  r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  if (lo) {
    u[0] = r0;
    u[2] = r1;
  } else {
    u[1] = r0;
    u[3] = r1;
  }
}

// Units (m tile, n tile), m tile fastest, dealt round robin to a persistent grid. `vec`: N fills whole 16-byte
// vectors of the output (N % 8 == 0 for 16-bit, N % 4 == 0 for fp32) and ws is 8-byte aligned.
template <typename TO, int BN>
__global__ void __launch_bounds__(pre::kThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                  const float* __restrict__ xs, const float* __restrict__ ws, TO* __restrict__ out, int M, int N,
                  int K, int vec) {
  using namespace pre;
  using Tl = Tile<BN>;
  constexpr int kStages = Tl::kStages, kStageBytes = Tl::kStageBytes;
  extern __shared__ __align__(16) uint8_t int8_wg_raw[];
  uint8_t* ring = int8_wg_raw + (1024 - smem_addr(int8_wg_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;  // warpgroup: 0, 1 consume, 2 loads
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + BN - 1) / BN, k_tiles = (K + kBK - 1) / kBK;
  const int units = m_tiles * n_tiles;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);   // the producer's arrive, plus the stage's bytes
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
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u % m_tiles) * kBM, n0 = (u / m_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(st, &map_x, &full[stage], kt * kBK, m0);
          tma_load_2d(st + kABytes, &map_w, &full[stage], kt * kBK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup `role` owns rows [64 role, 64 role + 64) of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, q = lane % 4;
    const int row_in_tile = 64 * role + 16 * warp + lane / 4;
    const uint32_t ring_addr = smem_addr(ring);
    int acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u % m_tiles) * kBM, n0 = (u / m_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_tile = ring_addr + stage * kStageBytes, b_tile = a_tile + kABytes;
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) {
          wgmma_s8<BN>(acc, sw128_operand_desc<false>(a_tile, 64 * role, kk), sw128_operand_desc<false>(b_tile, 0, kk));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        wgmma_hold(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      wgmma_hold(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      // acc[4j + 2h + e]: row row_in_tile + 8h, column 8j + 2q + e of the tile
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row_in_tile + 8 * h;
        const bool row_ok = m < M;
        const float sx = row_ok ? xs[m] : 0.f;
        TO* o = out + static_cast<int64_t>(m) * N;
        if (vec) {
          if constexpr (sizeof(TO) == 2) {
            // four column groups of 8 (32 columns): the quad's words transposed, lane q stores group 4t + q
#pragma unroll
            for (int t = 0; t < BN / 32; ++t) {
              uint32_t w4[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 4 * t + i, n = n0 + 8 * j + 2 * q;  // N even: n < N means n + 1 < N
                const float2 sw = n < N ? *reinterpret_cast<const float2*>(ws + n) : make_float2(0.f, 0.f);
                w4[i] = mojo_bits16(mojo_from_float<TO>(dequant(acc[4 * j + 2 * h], sx, sw.x))) |
                        (mojo_bits16(mojo_from_float<TO>(dequant(acc[4 * j + 2 * h + 1], sx, sw.y))) << 16);
              }
              quad_transpose(w4, q);
              const int n = n0 + 32 * t + 8 * q;
              if (row_ok && n < N) *reinterpret_cast<uint4*>(o + n) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
            }
          } else {
            // pairs of column groups: even lanes store group 2t's 4 columns from 2q, odd lanes group 2t + 1's from
            // 2q - 2
            const bool lo = q & 1;
#pragma unroll
            for (int t = 0; t < BN / 16; ++t) {
              float v[2][2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int j = 2 * t + i, n = n0 + 8 * j + 2 * q;
                const float2 sw = n < N ? *reinterpret_cast<const float2*>(ws + n) : make_float2(0.f, 0.f);
                v[i][0] = dequant(acc[4 * j + 2 * h], sx, sw.x);
                v[i][1] = dequant(acc[4 * j + 2 * h + 1], sx, sw.y);
              }
              const float r0 = __shfl_xor_sync(0xffffffffu, lo ? v[0][0] : v[1][0], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, lo ? v[0][1] : v[1][1], 1);
              const float4 st = lo ? make_float4(r0, r1, v[1][0], v[1][1]) : make_float4(v[0][0], v[0][1], r0, r1);
              const int n = lo ? n0 + 16 * t + 8 + 2 * q - 2 : n0 + 16 * t + 2 * q;
              if (row_ok && n < N) *reinterpret_cast<float4*>(o + n) = st;
            }
          }
        } else if (row_ok) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = n0 + 8 * j + 2 * q + e;
              if (n < N) o[n] = mojo_from_float<TO>(dequant(acc[4 * j + 2 * h + e], sx, ws[n]));
            }
          }
        }
      }
    }
  }
}

template <typename TO, int BN>
int launch_wgmma(const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out, int M, int N, int K,
                 cudaStream_t s) {
  using namespace pre;
  CUtensorMap map_x, map_w;
  int rc = encode_tile_map_u8(&map_x, x, K, M, K, kBM);
  if (rc == 0) rc = encode_tile_map_u8(&map_w, w, K, N, K, BN);
  if (rc != 0) return rc;
  auto* kernel = int8_wgmma_kernel<TO, BN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t units = static_cast<int64_t>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(units < sm_count() ? units : sm_count());
  constexpr int per_vec = 16 / static_cast<int>(sizeof(TO));
  const int vec = N % per_vec == 0 && reinterpret_cast<uintptr_t>(ws) % 8 == 0;
  kernel<<<grid, kThreads, Tile<BN>::kSmem, s>>>(map_x, map_w, xs, ws, out, M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int dispatch_route(int route, bool trans, const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out,
                   int* part, int* arrivals, int M, int N, int K, int splits, cudaStream_t s) {
  switch (route) {
    case kRouteWgmma128:
    case kRouteWgmma256:
      if (!trans || splits != 1 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
      return route == kRouteWgmma256 ? launch_wgmma<TO, 256>(x, w, xs, ws, out, M, N, K, s)
                                     : launch_wgmma<TO, 128>(x, w, xs, ws, out, M, N, K, s);
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
