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
// Design: two routes, which the wrapper chooses from shapes (group_quant_gemm.route). Every block sums in a fixed
// order with no atomics: results repeat bit for bit.
//   decode (M < 32 G, few rows a group): kernel H's row tiles of 16 rows found by each block from the counts on
//     the device (group_tiles.cuh locate_tile), the grid sized by the static bound min(ceil(M / 16) + G, M) and
//     the surplus blocks zeroing the rows past the groups' end; 16 x 32 output tiles of 4 warps, mma.sync.m16n8k32
//     s8 fed by a 4-stage cp.async ring of 128-byte k stages, (N, K) fragments by 32-bit shared loads from rows
//     padded by 16 bytes. Packed int4: a stage holds 16 packed rows, and lanes g and g ^ 1 read one packed word as
//     16 x the weights of its low or high nibbles (nib16_lo / nib16_hi, int_wgmma.cuh).
//   prefill (M >= 32 G): kernel H's prefill design on kernel F's s8 wgmma mainloop (int_wgmma.cuh pre::). One
//     launch writes the row tiles of 128 rows from the counts into a scratch table (group_tile_table); a
//     persistent grid of one block an SM walks (row tile, n tile) units, the n tile fastest, so the blocks in
//     flight share an expert's x rows in L2 and each n tile of a slab streams from HBM once. A producer thread
//     keeps 128-byte k slices of x's 128 rows and of the slab's BN rows in flight by TMA (128-byte swizzle); two
//     consumer warpgroups run wgmma m64nBNk32 s8 into int32 registers; the epilogue stores 16 bytes a lane. BN
//     128 for int8, 256 for packed int4 (split_sweep gqmm). Packed int4 brings BN / 2 packed rows a stage, which
//     the consumers unpack once into the int8 B tile as 16 x the weights (kernel G's unpack_stage), the sums
//     shifted right by 4 before the epilogue.
// A packed int4 sum is exact in int32 for K <= kMaxPackedK.
#include "group_tiles.cuh"
#include "int_wgmma.cuh"

namespace {

// route codes shared with backends/cuda/kernels/group_quant_gemm.py
enum GroupQuantRoute : int { kRouteDecode = 0, kRouteWgmma = 1, kRouteWgmmaWide = 2 };

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

// -- the prefill route: wgmma s8 fed by TMA -----------------------------------------

// One output value in the golden's order, (float(sum) * ws) * xs; the caller rounds it once
__device__ __forceinline__ float gq_value(int acc, float sw, float sx) { return static_cast<float>(acc) * sw * sx; }

// Kernel F's persistent three-warpgroup kernel (int_wgmma.cuh, pre::) over H's units: (row tile, n tile) from the
// row-tile table, the n tile fastest, dealt round robin. The producer's TMA loads bring x's 128 rows at the tile's
// first row and W's BN rows (or BN / 2 packed rows) at g N + n0 of the (G N, K) slabs, 128-byte k slices; rows of
// the next group in a box, and columns past N, are computed and never stored. With INT4 the consumers unpack each
// stage as G does (unpack_stage): per 128 columns of the tile, packed rows p = 64 i + r give B rows 128 i + r (low
// nibbles, channel n0 + 128 i + 2 r) and 128 i + 64 + r (high, channel + 1), so accumulator columns c and c + 64
// of a 128-column group are the channel pair (2 c', 2 c' + 1) and each lane holds four adjacent channels a column
// group: one pair exchange makes its 16-byte stores. `vec`: N fills 16-byte vectors of the output and ws is
// 16-byte aligned.
template <typename TO, int BN, bool INT4>
__global__ void __launch_bounds__(pre::kThreads, 1)
group_quant_wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                         const int4* __restrict__ table, const int* __restrict__ meta, const float* __restrict__ xs,
                         const float* __restrict__ ws, TO* __restrict__ out, int M, int N, int K, int vec) {
  using namespace pre;
  using Tl = Tile<BN, INT4>;
  constexpr int kStages = Tl::kStages, kStageBytes = Tl::kStageBytes;
  extern __shared__ __align__(16) uint8_t gq_wg_raw[];
  uint8_t* ring = gq_wg_raw + (1024 - smem_addr(gq_wg_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;  // warpgroup: 0, 1 consume (and unpack), 2 loads
  const int n_tiles = (N + BN - 1) / BN, k_tiles = (K + kBK - 1) / kBK;
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
        const int n0 = (u % n_tiles) * BN;
        const int w_row = INT4 ? t.x * (N / 2) + n0 / 2 : t.x * N + n0;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], Tl::kLoadBytes);
          tma_load_2d(st, &map_x, &full[stage], kt * kBK, t.y);
          tma_load_2d(st + kABytes + (INT4 ? Tl::kBBytes : 0), &map_w, &full[stage], kt * kBK, w_row);
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
      const int4 t = table[u / n_tiles];
      const int n0 = (u % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_tile = ring_addr + stage * kStageBytes, b_tile = a_tile + kABytes;
        if constexpr (INT4) {
          uint8_t* st = ring + stage * kStageBytes;
          unpack_stage<BN>(st + kABytes + Tl::kBBytes, st + kABytes);
          consumer_sync();  // both warpgroups' halves of the B tile are in place
        }
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
      if constexpr (INT4) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] >>= 4;  // 16 x the int4 sums, exactly
      }
      // acc[4j + 2h + e]: row row_in_tile + 8h, column 8j + 2q + e of the tile; rows of the next group masked
      const float* wsg = ws + static_cast<int64_t>(t.x) * N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = t.y + row_in_tile + 8 * h;
        const bool row_ok = m < t.z;
        const float sx = row_ok ? xs[m] : 0.f;
        TO* o = out + static_cast<int64_t>(m) * N;
        if (vec && INT4) {
          // column group 8 j4 + jj of 128-column group i: channels n0 + 128 i + 16 jj + 4 q .. + 3, from columns
          // j = 16 i + jj (low) and j + 8 (high), e 0 then 1
#pragma unroll
          for (int i = 0; i < BN / 128; ++i) {
            if constexpr (sizeof(TO) == 2) {
              // pairs of column groups: even lanes store group 2 p's 8 channels from 4 q, odd lanes group 2 p + 1's
              // from 4 q - 4
              const bool odd = q & 1;
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                uint32_t v[2][2];
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                  const int jj = 2 * p + b, jl = 16 * i + jj, jh = jl + 8, c = n0 + 128 * i + 16 * jj + 4 * q;
                  const float4 sw = c < N ? *reinterpret_cast<const float4*>(wsg + c) : make_float4(0.f, 0.f, 0.f, 0.f);
                  v[b][0] = mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * jl + 2 * h], sw.x, sx))) |
                            (mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * jh + 2 * h], sw.y, sx))) << 16);
                  v[b][1] = mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * jl + 2 * h + 1], sw.z, sx))) |
                            (mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * jh + 2 * h + 1], sw.w, sx))) << 16);
                }
                const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0][0] : v[1][0], 1);
                const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[0][1] : v[1][1], 1);
                const uint4 st = odd ? make_uint4(r0, r1, v[1][0], v[1][1]) : make_uint4(v[0][0], v[0][1], r0, r1);
                const int c = odd ? n0 + 128 * i + 32 * p + 16 + 4 * q - 4 : n0 + 128 * i + 32 * p + 4 * q;
                if (row_ok && c < N) *reinterpret_cast<uint4*>(o + c) = st;
              }
            } else {
              // fp32: a lane's four channels are one 16-byte vector
#pragma unroll
              for (int jj = 0; jj < 8; ++jj) {
                const int jl = 16 * i + jj, jh = jl + 8, c = n0 + 128 * i + 16 * jj + 4 * q;
                const float4 sw = c < N ? *reinterpret_cast<const float4*>(wsg + c) : make_float4(0.f, 0.f, 0.f, 0.f);
                const float4 st = make_float4(gq_value(acc[4 * jl + 2 * h], sw.x, sx), gq_value(acc[4 * jh + 2 * h], sw.y, sx),
                                              gq_value(acc[4 * jl + 2 * h + 1], sw.z, sx),
                                              gq_value(acc[4 * jh + 2 * h + 1], sw.w, sx));
                if (row_ok && c < N) *reinterpret_cast<float4*>(o + c) = st;
              }
            }
          }
        } else if (vec) {
          if constexpr (sizeof(TO) == 2) {
            // four column groups of 8 (32 columns): the quad's words transposed, lane q stores group 4 p + q
#pragma unroll
            for (int p = 0; p < BN / 32; ++p) {
              uint32_t w4[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 4 * p + i, c = n0 + 8 * j + 2 * q;  // N even: c < N means c + 1 < N
                const float2 sw = c < N ? *reinterpret_cast<const float2*>(wsg + c) : make_float2(0.f, 0.f);
                w4[i] = mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * j + 2 * h], sw.x, sx))) |
                        (mojo_bits16(mojo_from_float<TO>(gq_value(acc[4 * j + 2 * h + 1], sw.y, sx))) << 16);
              }
              quad_transpose(w4, q);
              const int c = n0 + 32 * p + 8 * q;
              if (row_ok && c < N) *reinterpret_cast<uint4*>(o + c) = make_uint4(w4[0], w4[1], w4[2], w4[3]);
            }
          } else {
            // pairs of column groups: even lanes store group 2 p's 4 columns from 2 q, odd lanes group 2 p + 1's
            // from 2 q - 2
            const bool odd = q & 1;
#pragma unroll
            for (int p = 0; p < BN / 16; ++p) {
              float v[2][2];
#pragma unroll
              for (int i = 0; i < 2; ++i) {
                const int j = 2 * p + i, c = n0 + 8 * j + 2 * q;
                const float2 sw = c < N ? *reinterpret_cast<const float2*>(wsg + c) : make_float2(0.f, 0.f);
                v[i][0] = gq_value(acc[4 * j + 2 * h], sw.x, sx);
                v[i][1] = gq_value(acc[4 * j + 2 * h + 1], sw.y, sx);
              }
              const float r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0][0] : v[1][0], 1);
              const float r1 = __shfl_xor_sync(0xffffffffu, odd ? v[0][1] : v[1][1], 1);
              const float4 st = odd ? make_float4(r0, r1, v[1][0], v[1][1]) : make_float4(v[0][0], v[0][1], r0, r1);
              const int c = odd ? n0 + 16 * p + 8 + 2 * q - 2 : n0 + 16 * p + 2 * q;
              if (row_ok && c < N) *reinterpret_cast<float4*>(o + c) = st;
            }
          }
        } else if (row_ok) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * q + e, cc = col % 128;
              const int c = n0 + (INT4 ? col - cc + 2 * (cc % 64) + cc / 64 : col);
              if (c < N) o[c] = mojo_from_float<TO>(gq_value(acc[4 * j + 2 * h + e], wsg[c], sx));
            }
          }
        }
      }
    }
    // the rows past the groups' end are zero
    const int filled = meta[1];
    const int64_t n_zero = static_cast<int64_t>(M - filled) * N;
    TO* tail = out + static_cast<int64_t>(filled) * N;
    for (int64_t i = blockIdx.x * kConsumerThreads + threadIdx.x; i < n_zero;
         i += static_cast<int64_t>(gridDim.x) * kConsumerThreads) {
      tail[i] = mojo_from_float<TO>(0.0f);
    }
  }
}

// The prefill route: the table launch, then the persistent wgmma grid. scratch holds scratch_ints int32 (4 per
// row tile of the bound, then 2).
template <typename TO, int BN, bool INT4>
int launch_wgmma_route(const int8_t* x, const int8_t* w, const int* gs, const float* xs, const float* ws, TO* out,
                       int* scratch, int64_t scratch_ints, int M, int N, int K, int G, cudaStream_t s) {
  using namespace pre;
  const int bound = row_tiles(M, G, kBM);
  if (scratch == nullptr || 4 * static_cast<int64_t>(bound) + 2 > scratch_ints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_x, map_w;
  int rc = encode_tile_map_u8(&map_x, x, K, M, K, kBM);
  if (rc == 0) {
    rc = encode_tile_map_u8(&map_w, w, K, static_cast<uint64_t>(G) * (INT4 ? N / 2 : N), K, INT4 ? BN / 2 : BN);
  }
  if (rc != 0) return rc;
  auto* kernel = group_quant_wgmma_kernel<TO, BN, INT4>;
  constexpr int kSmem = Tile<BN, INT4>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int4* table = reinterpret_cast<int4*>(scratch);
  int* meta = scratch + 4 * bound;
  group_tile_table<kBM><<<1, kTileTableThreads, 0, s>>>(gs, G, M, table, meta);
  if (cudaError_t err = cudaGetLastError(); err != cudaSuccess) return static_cast<int>(err);
  const int64_t units_bound = static_cast<int64_t>(bound) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(units_bound < sm_count() ? units_bound : sm_count());
  constexpr int per_vec = 16 / static_cast<int>(sizeof(TO));
  const int vec = N % per_vec == 0 && reinterpret_cast<uintptr_t>(ws) % 16 == 0;
  kernel<<<grid, kThreads, kSmem, s>>>(map_x, map_w, table, meta, xs, ws, out, M, N, K, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int dispatch_route(int route, bool int4, const int8_t* x, const int8_t* w, const int* gs, const float* xs,
                   const float* ws, TO* out, int* scratch, int64_t scratch_ints, int M, int N, int K, int G,
                   cudaStream_t s) {
  switch (route) {
    case kRouteWgmma:
      return int4 ? launch_wgmma_route<TO, 128, true>(x, w, gs, xs, ws, out, scratch, scratch_ints, M, N, K, G, s)
                  : launch_wgmma_route<TO, 128, false>(x, w, gs, xs, ws, out, scratch, scratch_ints, M, N, K, G, s);
    case kRouteWgmmaWide:
      return int4 ? launch_wgmma_route<TO, 256, true>(x, w, gs, xs, ws, out, scratch, scratch_ints, M, N, K, G, s)
                  : launch_wgmma_route<TO, 256, false>(x, w, gs, xs, ws, out, scratch, scratch_ints, M, N, K, G, s);
    case kRouteDecode:
      return int4 ? launch<TO, DecodeTile<true>>(x, w, gs, xs, ws, out, M, N, K, G, s)
                  : launch<TO, DecodeTile<false>>(x, w, gs, xs, ws, out, M, N, K, G, s);
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
                                     const void* ws, void* out, void* scratch, long long scratch_ints, int M, int N,
                                     int K, int G, int int4, int route, int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (G <= 0 || K <= 0 || K % 16 != 0 || (int4 && (N % 2 != 0 || K > kMaxPackedK))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    rc = dispatch_route<TO>(route, int4 != 0, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                            static_cast<const int*>(group_sizes), static_cast<const float*>(xs),
                            static_cast<const float*>(ws), static_cast<TO*>(out), static_cast<int*>(scratch),
                            scratch_ints, M, N, K, G, s);
  });
  return rc;
}
