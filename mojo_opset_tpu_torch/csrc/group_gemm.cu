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
// Design. A row tile belongs to one group and starts at that group's first
// row or BM rows after: no 8-aligned overlapping windows, no read-merge-
// write of boundary rows and no reliance on grid order, which the TPU
// kernel needs because Mosaic DMAs want 8-aligned sublane offsets and its
// grid runs in order on one core. The host never reads the counts: the
// tiles are found on the device from group_sizes, and the grid is sized by
// a static bound, min(ceil(M / BM) + G, M) row tiles (every tile holds at
// least one row). The rows past the groups' end are zeroed by the blocks
// too. Three routes:
//   prefill tile (bf16/fp16 with at least 32 rows a group, M >= 32 G, as
//   the wrapper chooses from shapes): Hopper's wgmma fed by TMA
//     (hopper.cuh), in the shape of kernel N: a persistent grid of one
//     block an SM, each of three warpgroups; the first thread of the third
//     keeps a ring of 4 stages of TMA loads in flight (64-deep k slices of
//     x's 128 rows and of W's 256 n columns, in the 128-byte swizzle, a
//     full and an empty mbarrier a stage), and the two consumer warpgroups
//     each own 64 rows of the 128 x 256 output tile (m64n256k16, fp32
//     accumulators in registers, one group in flight while the next stage
//     lands). x is a K-major A operand; a (G, N, K) W a K-major B operand
//     over its (G N, K) rows; a (G, K, N) W is read MN-major over its
//     (G K, N) rows through the transpose bit. A box starts at any row: x
//     rows of the next group that it pulls in are masked at the store; W
//     rows of the next group past K meet x's zero-filled columns past K.
//     A first launch of one block writes the row-tile table (group, first
//     row, end row) to a scratch buffer; the work units are (row tile,
//     n tile) with the n tile fastest, dealt to the blocks round robin, so
//     the blocks in flight hold a few experts' n tiles together: their x
//     rows stay in L2 and each n tile of a weight slab streams from HBM
//     once.
//   decode tile (bf16/fp16, M < 32 G, few rows per group): 16 x 64 tiles,
//     4 warps along N on mma.sync.m16n8k16 (fp32 accumulators) fed by a
//     4-stage cp.async ring; one block per (row tile, n tile) finds its
//     group by scanning the counts in shared memory, so one row tile covers
//     an expert's tokens and reads its slab once per n tile. The stored
//     (N, K) weight is the "col" B operand of the instruction (32-bit
//     shared loads); a (K, N) weight gathers two 16-bit values a word.
//   fp32 (small test models): a shared-memory FMA kernel, as the decode
//     tile's grid.
// Every route sums in a fixed order: results repeat bit for bit.
#include "common.cuh"
#include "group_tiles.cuh"
#include "hopper.cuh"

namespace {

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

template <typename T, typename C, bool TRANS>
int launch_mma(const T* x, const T* w, const int* gs, T* out, int M, int N, int K, int G, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gmm_mma_kernel<T, C, TRANS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(row_tiles(M, G, C::BM), (N + C::BN - 1) / C::BN);
  gmm_mma_kernel<T, C, TRANS><<<grid, C::THREADS, C::SMEM, stream>>>(x, w, gs, out, M, N, K, G);
  return static_cast<int>(cudaGetLastError());
}

// -- the prefill tile: wgmma fed by TMA --------------------------------------------

namespace pre {
constexpr int kBM = 128;       // tile rows: two consumer warpgroups of 64
constexpr int kBN = 256;       // tile columns: m64n256k16
constexpr int kBK = kSw128K;   // K of a stage: one 128-byte swizzle row
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroups 0-1 consume; warpgroup 2's first thread loads
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK * 2;
constexpr int kStageBytes = kABytes + kBN * kBK * 2;
// the stages, slack to align them on 1024 bytes, a full and an empty barrier a stage
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
}  // namespace pre

// Units (row tile, n tile), n tile fastest, dealt round robin to a
// persistent grid. W's map: (G N, K) rows K-major, or with BMN (a (G, K, N)
// weight) (G K, N) rows read MN-major.
template <typename T, bool BMN>
__global__ void __launch_bounds__(pre::kThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                 const int4* __restrict__ table, const int* __restrict__ meta, T* __restrict__ out, int M, int N,
                 int K) {
  using namespace pre;
  extern __shared__ __align__(16) uint8_t gmm_wg_raw[];
  uint8_t* ring = gmm_wg_raw + (1024 - smem_addr(gmm_wg_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;  // warpgroup: 0, 1 consume, 2 loads
  const int n_tiles = (N + kBN - 1) / kBN, k_tiles = (K + kBK - 1) / kBK;
  const int units = meta[0] * n_tiles;
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
        const int4 t = table[u / n_tiles];
        const int n0 = (u % n_tiles) * kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_operand<kBM, false>(st, &map_x, &full[stage], t.y, kt * kBK);
          if constexpr (BMN) {
            tma_load_operand<kBN, true>(st + kABytes, &map_w, &full[stage], n0, t.x * K + kt * kBK);
          } else {
            tma_load_operand<kBN, false>(st + kABytes, &map_w, &full[stage], t.x * N + n0, kt * kBK);
          }
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
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int row_in_tile = 64 * role + 16 * warp + lane / 4, col_in_tile = 2 * (lane % 4);
    const uint32_t ring_addr = smem_addr(ring);
    const bool pairs = N % 2 == 0;  // output rows 4-byte aligned: columns go out two at a time
    float acc[kBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int4 t = table[u / n_tiles];
      const int n0 = (u % n_tiles) * kBN;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_tile = ring_addr + stage * kStageBytes, b_tile = a_tile + kABytes;
        wgmma_hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_m64n256k16<T, 0, BMN>(acc, sw128_operand_desc<false>(a_tile, 64 * role, kk),
                                      sw128_operand_desc<BMN>(b_tile, 0, kk));
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
      // acc[4j + 2h + e]: row row_in_tile + 8h, column col_in_tile + 8j + e; rows of the next group masked
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t.y + row_in_tile + 8 * h;
        if (r >= t.z) continue;
        T* o = out + static_cast<int64_t>(r) * N;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int v = n0 + col_in_tile + 8 * j;
          if (v >= N) continue;
          const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
          if (pairs) {  // N even: v + 1 < N too
            mojo_store2<T>(o + v, x, y);
          } else {
            o[v] = mojo_from_float<T>(x);
            if (v + 1 < N) o[v + 1] = mojo_from_float<T>(y);
          }
        }
      }
    }
    // the rows past the groups' end are zero
    const int filled = meta[1];
    const int64_t n_zero = static_cast<int64_t>(M - filled) * N;
    T* tail = out + static_cast<int64_t>(filled) * N;
    for (int64_t i = blockIdx.x * 256 + threadIdx.x; i < n_zero; i += static_cast<int64_t>(gridDim.x) * 256) {
      tail[i] = mojo_from_float<T>(0.0f);
    }
  }
}

// The prefill tile: the table launch, then the persistent wgmma grid.
// scratch holds scratch_ints int32 (4 per row tile, then 2).
template <typename T, bool TRANS>
int launch_wgmma(const T* x, const T* w, const int* gs, T* out, int* scratch, int64_t scratch_ints, int M, int N,
                 int K, int G, cudaStream_t s) {
  using namespace pre;
  const int bound = row_tiles(M, G, kBM);
  if (4 * static_cast<int64_t>(bound) + 2 > scratch_ints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr bool bf16 = std::is_same_v<T, __nv_bfloat16>;
  CUtensorMap map_x, map_w;
  int rc = encode_tile_map(&map_x, bf16, x, K, M, static_cast<uint64_t>(K) * 2, kBM);
  if (rc == 0) {
    rc = TRANS ? encode_tile_map(&map_w, bf16, w, K, static_cast<uint64_t>(G) * N, static_cast<uint64_t>(K) * 2, kBN)
               : encode_tile_map(&map_w, bf16, w, N, static_cast<uint64_t>(G) * K, static_cast<uint64_t>(N) * 2, 64);
  }
  if (rc != 0) return rc;
  auto* kernel = gmm_wgmma_kernel<T, !TRANS>;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int4* table = reinterpret_cast<int4*>(scratch);
  int* meta = scratch + 4 * bound;
  group_tile_table<kBM><<<1, kTileTableThreads, 0, s>>>(gs, G, M, table, meta);
  if (cudaError_t err = cudaGetLastError(); err != cudaSuccess) return static_cast<int>(err);
  const int64_t units_bound = static_cast<int64_t>(bound) * ((N + kBN - 1) / kBN);
  const int grid = static_cast<int>(units_bound < sm_count() ? units_bound : sm_count());
  kernel<<<grid, kThreads, kSmem, s>>>(map_x, map_w, table, meta, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper chooses the tile from shapes (group_gemm.uses_prefill_tile): a
// scratch buffer asks for the prefill tile, none for the decode tile.
template <typename T, bool TRANS>
int dispatch_tile(const T* x, const T* w, const int* gs, T* out, int* scratch, int64_t scratch_ints, int M, int N,
                  int K, int G, cudaStream_t s) {
  if (scratch == nullptr) return launch_mma<T, DecodeTile, TRANS>(x, w, gs, out, M, N, K, G, s);
  return launch_wgmma<T, TRANS>(x, w, gs, out, scratch, scratch_ints, M, N, K, G, s);
}

}  // namespace

// x: (M, K); w: (G, N, K) when trans_weight, else (G, K, N); group_sizes:
// (G,) int32; out: (M, N); scratch: null for the decode tile, or
// scratch_ints int32 for the prefill tile's row-tile table (4 (ceil(M /
// 128) + G) + 2 suffice; 16-bit inputs only). x, w and out
// share `dtype`; all contiguous and 16-byte aligned. For 16-bit types
// K % 8 == 0, and N % 8 == 0 for a (G, K, N) w (TMA's 16-byte row pitch).
extern "C" int mojo_group_gemm(const void* x, const void* w, const void* group_sizes, void* out, void* scratch,
                               long long scratch_ints, int M, int N, int K, int G, int trans_weight, int dtype,
                               void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (G <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  int* sc = static_cast<int*>(scratch);
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
      rc = trans_weight ? dispatch_tile<__half, true>(xh, wh, gs, oh, sc, scratch_ints, M, N, K, G, s)
                        : dispatch_tile<__half, false>(xh, wh, gs, oh, sc, scratch_ints, M, N, K, G, s);
      break;
    }
    case kMojoBF16: {
      const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
      const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
      rc = trans_weight ? dispatch_tile<__nv_bfloat16, true>(xb, wb, gs, ob, sc, scratch_ints, M, N, K, G, s)
                        : dispatch_tile<__nv_bfloat16, false>(xb, wb, gs, ob, sc, scratch_ints, M, N, K, G, s);
      break;
    }
    default:
      break;
  }
  return rc;
}
