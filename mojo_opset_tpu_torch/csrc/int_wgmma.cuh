// The integer GEMMs' shared parts: the s8 mma.sync tile op, the dequant
// epilogue, the nibble unpack of packed int4 bytes, and the prefill route
// of kernels F (int8_matmul.cu) and G (int4_matmul.cu): Hopper's wgmma
// m64nNk32 s8 fed by TMA (hopper.cuh).
//
// The prefill kernel: a persistent grid of one block an SM, three
// warpgroups. The first thread of the third keeps a ring of TMA loads in
// flight (128-byte k slices of x's 128 rows and of W's BN rows, in the
// 128-byte swizzle, a full and an empty mbarrier a stage); the two
// consumer warpgroups each own 64 rows of the 128 x BN output tile (int32
// accumulators in registers, one group in flight while the next stage
// lands). Both operands are K-major, as 8-bit wgmma requires.
//
// PACKED (kernel G): W is the pack_int4_rows layout, (N / 2, K) bytes, and
// TMA brings BN / 2 packed rows a stage. A box of 64 packed rows is one
// 128-channel group: its low nibbles are the group's first 64 channels and
// its high nibbles the last 64. Once a stage lands, the consumers unpack
// its packed tile into the int8 B tile wgmma reads, 16 bytes a thread at a
// time, while the previous stage's products run; a barrier of the two
// consumer warpgroups closes the stage's unpacking. Packed row r goes to B
// rows 128 (r / 64) + r % 64 (low) and that + 64 (high), so the tile's
// columns are BN consecutive channels, as in F. Those rows are congruent
// to r mod 8, so the 128-byte swizzle puts a chunk at the same place in
// every one of them: each 16-byte chunk unpacks to the same offset in the
// low and the high half of its group's B rows, and no address is
// recomputed. The B tile holds 16 x the weights (nib16_lo / nib16_hi), so
// the int32 sums are 16 x the int4 sums, shifted right by 4 before the
// epilogue.
//
// Units (m tile, k split, n tile), the m tile fastest, so the blocks in
// flight share a weight slab, dealt round robin. With one split the
// consumers dequantize and store; with more each split writes its int32
// tile to `part`, and the last of a tile's splits to arrive (a counter an
// output tile, zero on entry, which it returns to 0) sums the splits in
// split order and stores. TMA zero-fills rows past M and N and k past K,
// and a zero adds nothing to an integer sum: only the store is masked. The
// epilogue loads ws two columns at a time and swaps values inside each
// quad of lanes (16-bit output) or pair (fp32) so that every lane stores
// 16 contiguous bytes.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

// in an unnamed namespace: each source that includes it keeps its own copy
namespace {

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw) { return static_cast<float>(acc) * sx * sw; }

// Four packed bytes -> sixteen times the signed int4 of their low (resp. high) nibbles, as four int8, byte order
// kept: the nibble at the top of its byte and the bottom cleared is 16 x its two's-complement value, -128..112, so
// one or two integer ops a word unpack it. A product with x is 16 x the int4 one, at most 2^14 in size: an int32
// sum over K <= kMaxPackedK (< 2^17) holds it exactly, and an arithmetic shift right by 4 gives the int4 sum.
constexpr int kMaxPackedK = (1 << 17) - 16;

__device__ __forceinline__ int nib16_lo(uint32_t p) { return static_cast<int>((p << 4) & 0xF0F0F0F0u); }

__device__ __forceinline__ int nib16_hi(uint32_t p) { return static_cast<int>(p & 0xF0F0F0F0u); }

namespace pre {
constexpr int kBM = 128;        // tile rows: two consumer warpgroups of 64
constexpr int kBK = kSw128K8;   // K of a stage: one 128-byte swizzle row of int8
constexpr int kThreads = 384;   // warpgroups 0-1 consume; warpgroup 2's first thread loads
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK;
constexpr int kConsumerThreads = 256;

template <int BN, bool PACKED>
struct Tile {
  static constexpr int kBBytes = BN * kBK;                           // the int8 tile wgmma reads
  static constexpr int kPackedBytes = PACKED ? BN / 2 * kBK : 0;     // the packed tile TMA brings
  static constexpr int kLoadBytes = kABytes + (PACKED ? kPackedBytes : kBBytes);
  static constexpr int kStageBytes = kABytes + kBBytes + kPackedBytes;  // A, B, then the packed tile
  // F: 4 stages of a 128 x 256 tile, 6 of a 128 x 128 one; G: 3 and 5
  static constexpr int kStages = (PACKED ? 200 * 1024 : 192 * 1024) / kStageBytes;
  // the stages, slack to align them on 1024 bytes, a full and an empty barrier a stage
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
  static_assert(kBBytes % 1024 == 0 && kPackedBytes % 1024 == 0, "1024-byte aligned swizzled tiles");
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

// the two consumer warpgroups' barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// PACKED: the stage's packed tile (BN / 2 rows of 128 bytes, 16-byte chunk c of it) unpacked into its B tile by
// the 256 consumer threads, BN / 64 chunks each, all loaded before any is stored
template <int BN>
__device__ __forceinline__ void unpack_stage(const uint8_t* packed, uint8_t* b) {
  constexpr int kPer = BN / 2 * 8 / pre::kConsumerThreads;
  uint4 p[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) p[i] = *reinterpret_cast<const uint4*>(packed + 16 * (threadIdx.x + i * 256));
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = threadIdx.x + i * pre::kConsumerThreads;
    uint8_t* lo = b + (c / 512) * 16384 + (c % 512) * 16;  // group c / 512, its low rows; the high rows 8 KB on
    *reinterpret_cast<uint4*>(lo) = make_uint4(nib16_lo(p[i].x), nib16_lo(p[i].y), nib16_lo(p[i].z), nib16_lo(p[i].w));
    *reinterpret_cast<uint4*>(lo + 8192) =
        make_uint4(nib16_hi(p[i].x), nib16_hi(p[i].y), nib16_hi(p[i].z), nib16_hi(p[i].w));
  }
  // the generic-proxy stores become visible to wgmma's reads (the async proxy) before the barrier
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `vec`: N fills whole 16-byte vectors of the output (N % 8 == 0 for 16-bit, N % 4 == 0 for fp32) and ws is
// 8-byte aligned. `splits` K ranges of whole k-tiles, none empty; with more than one, `part` holds splits x
// (m tiles x n tiles) x 128 x BN int32 and `arrivals` one zeroed int32 an output tile.
// The kernel's body; each source names its kernel with MOJO_INT_WGMMA_KERNEL (F int8_wgmma_kernel, G
// int4_wgmma_kernel), so a profile and the ptxas log tell them apart.
template <typename TO, int BN, bool PACKED>
__device__ __forceinline__ void int_wgmma_body(const CUtensorMap& map_x, const CUtensorMap& map_w,
                                               const float* __restrict__ xs, const float* __restrict__ ws,
                                               TO* __restrict__ out, int* __restrict__ part, int* arrivals, int M,
                                               int N, int K, int splits, int vec) {
  using namespace pre;
  using Tl = Tile<BN, PACKED>;
  constexpr int kStages = Tl::kStages, kStageBytes = Tl::kStageBytes;
  if constexpr (!PACKED) splits = 1;  // F's route never splits: its kernel carries no split code
  extern __shared__ __align__(16) uint8_t int_wg_raw[];
  __shared__ int is_last;
  uint8_t* ring = int_wg_raw + (1024 - smem_addr(int_wg_raw) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int role = threadIdx.x / 128;  // warpgroup: 0, 1 consume (and unpack), 2 loads
  const int m_tiles = (M + kBM - 1) / kBM, n_tiles = (N + BN - 1) / BN, k_tiles = (K + kBK - 1) / kBK;
  const int per = (k_tiles + splits - 1) / splits;  // k-tiles of a split
  const int units = m_tiles * n_tiles * splits;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);   // the producer's arrive, plus the stage's bytes
      mbar_init(&empty[st], 8);  // one arrive from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // unit u: m tile u % m_tiles, then split, then n tile
  auto unit_of = [&](int u, int& m0, int& n0, int& z, int& kt0, int& kn) {
    const int mt = u % m_tiles, rest = u / m_tiles;
    z = rest % splits;
    m0 = mt * kBM;
    n0 = (rest / splits) * BN;
    kt0 = z * per;
    kn = min(per, k_tiles - kt0);
  };

  if (role == 2) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      // producer: one thread keeps the ring full, in the consumers' order
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int m0, n0, z, kt0, kn;
        unit_of(u, m0, n0, z, kt0, kn);
        for (int kt = kt0; kt < kt0 + kn; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], Tl::kLoadBytes);
          tma_load_2d(st, &map_x, &full[stage], kt * kBK, m0);
          if constexpr (PACKED) {
            tma_load_2d(st + kABytes + Tl::kBBytes, &map_w, &full[stage], kt * kBK, n0 / 2);
          } else {
            tma_load_2d(st + kABytes, &map_w, &full[stage], kt * kBK, n0);
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
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, q = lane % 4;
    const int row_in_tile = 64 * role + 16 * warp + lane / 4;
    const uint32_t ring_addr = smem_addr(ring);
    int acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int m0, n0, z, kt0, kn;
      unit_of(u, m0, n0, z, kt0, kn);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      int prev = -1;
      for (int kt = 0; kt < kn; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_tile = ring_addr + stage * kStageBytes, b_tile = a_tile + kABytes;
        if constexpr (PACKED) {
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
      // acc[4j + 2h + e]: row row_in_tile + 8h, column 8j + 2q + e of the tile
      if (splits > 1) {
        // rows past M are never stored: their partial sums are neither written nor read
        const int tile = m0 / kBM + m_tiles * (n0 / BN), tiles = m_tiles * n_tiles;
        int* mine = part + (static_cast<int64_t>(z) * tiles + tile) * (kBM * BN);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m0 + row_in_tile + 8 * h >= M) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            *reinterpret_cast<int2*>(mine + (row_in_tile + 8 * h) * BN + 8 * j + 2 * q) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        __threadfence();  // this split's partial is visible before it is counted
        consumer_sync();
        if (threadIdx.x == 0) is_last = atomicAdd(&arrivals[tile], 1) == splits - 1;
        consumer_sync();
        if (!is_last) continue;
        __threadfence();
        // the last split: every split's sums, in split order
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        for (int s = 0; s < splits; ++s) {
          const int* theirs = part + (static_cast<int64_t>(s) * tiles + tile) * (kBM * BN);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m0 + row_in_tile + 8 * h >= M) continue;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int2 v =
                  __ldcg(reinterpret_cast<const int2*>(theirs + (row_in_tile + 8 * h) * BN + 8 * j + 2 * q));
              acc[4 * j + 2 * h] += v.x;
              acc[4 * j + 2 * h + 1] += v.y;
            }
          }
        }
        if (threadIdx.x == 0) arrivals[tile] = 0;  // ready for the next launch (and a CUDA graph's next replay)
      }
      if constexpr (PACKED) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] >>= 4;  // 16 x the int4 sums, exactly
      }
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

#define MOJO_INT_WGMMA_KERNEL(NAME, PACKED)                                                                      \
  template <typename TO, int BN>                                                                                  \
  __global__ void __launch_bounds__(pre::kThreads, 1)                                                             \
  NAME(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,                       \
       const float* __restrict__ xs, const float* __restrict__ ws, TO* __restrict__ out, int* __restrict__ part,   \
       int* arrivals, int M, int N, int K, int splits, int vec) {                                                 \
    int_wgmma_body<TO, BN, PACKED>(map_x, map_w, xs, ws, out, part, arrivals, M, N, K, splits, vec);              \
  }

// `kernel`: the source's MOJO_INT_WGMMA_KERNEL at <TO, BN>; x: (M, K) int8; w: (N, K) int8, or PACKED (N / 2, K)
// packed int4 bytes; the rest as int_wgmma_body's
template <typename TO, int BN, bool PACKED, typename Kernel>
int launch_wgmma(Kernel kernel, const int8_t* x, const int8_t* w, const float* xs, const float* ws, TO* out,
                 int* part, int* arrivals, int M, int N, int K, int splits, cudaStream_t s) {
  using namespace pre;
  const int k_tiles = (K + kBK - 1) / kBK;
  if (K <= 0 || (PACKED && K > kMaxPackedK) || splits < 1 || k_tiles < splits ||
      (splits > 1 && (part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (k_tiles + splits - 1) / splits;
  if ((k_tiles + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  CUtensorMap map_x, map_w;
  int rc = encode_tile_map_u8(&map_x, x, K, M, K, kBM);
  if (rc == 0) rc = encode_tile_map_u8(&map_w, w, K, PACKED ? N / 2 : N, K, PACKED ? BN / 2 : BN);
  if (rc != 0) return rc;
  constexpr int kSmem = Tile<BN, PACKED>::kSmem;
  static const cudaError_t attr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t units = static_cast<int64_t>((M + kBM - 1) / kBM) * ((N + BN - 1) / BN) * splits;
  const int grid = static_cast<int>(units < sm_count() ? units : sm_count());
  constexpr int per_vec = 16 / static_cast<int>(sizeof(TO));
  const int vec = N % per_vec == 0 && reinterpret_cast<uintptr_t>(ws) % 8 == 0;
  kernel<<<grid, kThreads, kSmem, s>>>(map_x, map_w, xs, ws, out, part, arrivals, M, N, K, splits, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
