// Kernel G: packed-int4 x int8 -> int32 GEMM with the per-token x
// per-channel dequant epilogue.
//
// Replaces the JAX package's backends/pallas/kernels/int4_matmul.py:85
// (int4_scaled_matmul; kernel body _int4_mm_kernel :54-71, unpack
// _unpack_block :40-51, pallas_call :114).
//
// out[m, n] = float(sum_k x[m, k] * W[n, k]) * xs[m] * ws[n], rounded once
// to the output dtype; W is unpacked from w_packed (N/2, K) int8, whose
// packed row j*64 + r holds channel j*128 + r in its low nibble
// (lo = ((p & 15) ^ 8) - 8) and channel j*128 + 64 + r in its high nibble
// (hi = p >> 4, arithmetic). The int32 sum is exact; the epilogue
// multiplies in that order, in fp32, as the golden does. No unpacked
// weight ever exists in device memory.
//
// Bound on the H100: at decode (M = batch, 1 for the speculative draft at
// bs 1, 5 for its verify) the bytes of the packed weights, 0.5 byte per
// weight, streamed once per step; at the draft's prefill (M = 512) the
// tensor cores. Two routes, which the wrapper picks from shapes alone
// (int4_matmul.route):
//   prefill (M > 16): the wgmma s8 + TMA kernel of int_wgmma.cuh in its
//     PACKED form (shared with kernel F): TMA brings 64 or 128 packed rows
//     (one or two 128-channel groups) a stage, the consumer warpgroups
//     unpack them into the int8 tile wgmma reads while the previous
//     stage's products run, 128 x 256 or 128 x 128 tiles, and K split over
//     the units where the output tiles alone would leave most SMs idle.
//   decode (M <= 16): a block owns 8 packed rows (16 channels) and a range
//     of K; grid (N / 16, splits), 1-16 warps a block. Each lane loads 16
//     bytes of one packed row straight into registers with a streaming
//     hint, four warp steps of 64 bytes a row in flight before any math;
//     the block's warps take alternate runs of steps and add their sums
//     through shared memory in warp order. The product is the
//     mma.sync.m16n8k32 s8 tile: a lane's 16 bytes of row g at k give its
//     two B fragments of two k32 steps, and x's rows g and g + 8 at the
//     same 16 bytes its A fragments, so the k order inside a step is the
//     load's own (the int32 sum does not depend on it). Where the blocks
//     would leave most SMs idle K is split over gridDim.y: each split
//     writes its int32 tile to scratch and the last block of a tile to
//     arrive (a counter an output tile, which it returns to 0) sums the
//     splits in order and runs the epilogue once.
// Nibbles are unpacked in registers with one or two integer ops a word,
// as 16 x their value (int_wgmma.cuh nib16_lo / nib16_hi); the int32 sums
// are 16 x the int4 sums, shifted right by 4 (exact) before the epilogue,
// which bounds K below 2^17. N % 128 == 0 and K % 16 == 0:
// every 16-byte load lies inside one row, wholly inside or outside K (past
// K the load is skipped and counts zero), and TMA's pitch is a multiple of
// 16. Integer sums are exact in any order: every route repeats bit for
// bit.
#include "int_wgmma.cuh"

namespace {

// route codes shared with backends/cuda/kernels/int4_matmul.py
enum Int4Route : int { kRouteDecode = 0, kRouteWgmma128 = 1, kRouteWgmma256 = 2 };

namespace dec {
constexpr int kMaxWarps = 16;  // warps a block: 1-16, from the wrapper
constexpr int kRows = 8;       // packed rows a block: 8 low-nibble and 8 high-nibble channels
constexpr int kStep = 64;      // bytes of K a warp step takes from each row: 4 lanes x 16
constexpr int kUnroll = 4;     // consecutive steps a warp has in flight
constexpr int kMaxM = 16;      // rows of x: the m16n8k32 tile's
}  // namespace dec

// 16 bytes read once: not kept in L1
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// x's 16 bytes at row m, column k (x is small and read by every block: cached)
__device__ __forceinline__ uint4 ld_x16(const int8_t* x, int m, int K, int k) {
  return __ldg(reinterpret_cast<const uint4*>(x + static_cast<int64_t>(m) * K + k));
}

// Split z = blockIdx.y takes warp steps [z steps_per_split, min((z + 1) steps_per_split, k_steps)); warp w of W =
// blockDim.x / 32 takes the runs of kUnroll steps numbered w, w + W, ... of its split. `part`: splits x (N / 16) x
// M x 16 int32, `arrivals` one zeroed int32 an output tile, when gridDim.y > 1.
template <typename TO>
__global__ void __launch_bounds__(dec::kMaxWarps * 32)
int4_decode_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp, const float* __restrict__ xs,
                   const float* __restrict__ ws, TO* __restrict__ out, int* __restrict__ part, int* arrivals, int M,
                   int N, int K, int steps_per_split) {
  using namespace dec;
  __shared__ int red[kMaxWarps][kMaxM][16];  // [warp][m][c]: c < 8 the low channels, else the high
  __shared__ int is_last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int tile = blockIdx.x, tiles = gridDim.x, splits = gridDim.y, z = blockIdx.y;
  const int p0 = tile * kRows;
  const int k_steps = (K + kStep - 1) / kStep;
  const int s_end = min((z + 1) * steps_per_split, k_steps);
  const int8_t* row = wp + static_cast<int64_t>(p0 + g) * K;

  int lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};  // the accumulator fragments of the low and high channels
  for (int s0 = z * steps_per_split + warp * kUnroll; s0 < s_end; s0 += warps * kUnroll) {
    uint4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = (s0 + u) * kStep + 16 * q;
      w[u] = s0 + u < s_end && k < K ? ld_stream16(row + k) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (s0 + u >= s_end) break;  // warp-uniform
      const int k = (s0 + u) * kStep + 16 * q;
      const bool k_ok = k < K;
      const uint4 xa = k_ok && g < M ? ld_x16(x, g, K, k) : make_uint4(0, 0, 0, 0);
      const uint4 xb = k_ok && g + 8 < M ? ld_x16(x, g + 8, K, k) : make_uint4(0, 0, 0, 0);
      const int a0[4] = {static_cast<int>(xa.x), static_cast<int>(xb.x), static_cast<int>(xa.y),
                         static_cast<int>(xb.y)};
      const int a1[4] = {static_cast<int>(xa.z), static_cast<int>(xb.z), static_cast<int>(xa.w),
                         static_cast<int>(xb.w)};
      const int b_lo0[2] = {nib16_lo(w[u].x), nib16_lo(w[u].y)};
      const int b_lo1[2] = {nib16_lo(w[u].z), nib16_lo(w[u].w)};
      const int b_hi0[2] = {nib16_hi(w[u].x), nib16_hi(w[u].y)};
      const int b_hi1[2] = {nib16_hi(w[u].z), nib16_hi(w[u].w)};
      mma_s8(lo, a0, b_lo0);
      mma_s8(lo, a1, b_lo1);
      mma_s8(hi, a0, b_hi0);
      mma_s8(hi, a1, b_hi1);
    }
  }

  // lo / hi[2h + e]: row g + 8h, packed row 2q + e of the block
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      red[warp][g + 8 * h][2 * q + e] = lo[2 * h + e];
      red[warp][g + 8 * h][8 + 2 * q + e] = hi[2 * h + e];
    }
  __syncthreads();

  // cell (m, c) of the block: packed row p0 + c % 8, its low (c < 8) or high channel
  auto store = [&](int m, int c, int sum) {
    const int p = p0 + c % 8, n = (p / 64) * 128 + (c < 8 ? 0 : 64) + p % 64;
    out[static_cast<int64_t>(m) * N + n] = mojo_from_float<TO>(dequant(sum >> 4, xs[m], ws[n]));  // 16 x the sum
  };
  auto block_sum = [&](int m, int c) {  // the warps' sums in warp order
    int sum = 0;
    for (int w = 0; w < warps; ++w) sum += red[w][m][c];
    return sum;
  };
  if (splits == 1) {
    for (int cell = threadIdx.x; cell < M * 16; cell += blockDim.x) {
      store(cell / 16, cell % 16, block_sum(cell / 16, cell % 16));
    }
    return;
  }
  for (int cell = threadIdx.x; cell < M * 16; cell += blockDim.x) {
    part[(static_cast<int64_t>(z) * tiles + tile) * M * 16 + cell] = block_sum(cell / 16, cell % 16);
  }
  __threadfence();  // this block's partials are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&arrivals[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: the splits' sums in split order, the epilogue once
  for (int cell = threadIdx.x; cell < M * 16; cell += blockDim.x) {
    int sum = 0;
    for (int s = 0; s < splits; ++s) sum += __ldcg(part + (static_cast<int64_t>(s) * tiles + tile) * M * 16 + cell);
    store(cell / 16, cell % 16, sum);
  }
  if (threadIdx.x == 0) arrivals[tile] = 0;  // ready for the next launch (and a CUDA graph's next replay)
}

template <typename TO>
int launch_decode(const int8_t* x, const int8_t* wp, const float* xs, const float* ws, TO* out, int* part,
                  int* arrivals, int M, int N, int K, int splits, int warps, cudaStream_t s) {
  const int k_steps = (K + dec::kStep - 1) / dec::kStep;
  if (M > dec::kMaxM || K <= 0 || K > kMaxPackedK || splits < 1 || k_steps < splits ||
      warps < 1 || warps > dec::kMaxWarps || (splits > 1 && (part == nullptr || arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (k_steps + splits - 1) / splits;
  if ((k_steps + per - 1) / per != splits) return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  const dim3 grid(N / 16, splits);
  int4_decode_kernel<TO><<<grid, 32 * warps, 0, s>>>(x, wp, xs, ws, out, part, arrivals, M, N, K, per);
  return static_cast<int>(cudaGetLastError());
}

MOJO_INT_WGMMA_KERNEL(int4_wgmma_kernel, true)

template <typename TO>
int dispatch_route(int route, const int8_t* x, const int8_t* wp, const float* xs, const float* ws, TO* out, int* part,
                   int* arrivals, int M, int N, int K, int splits, int warps, cudaStream_t s) {
  switch (route) {
    case kRouteDecode:
      return launch_decode<TO>(x, wp, xs, ws, out, part, arrivals, M, N, K, splits, warps, s);
    case kRouteWgmma128:
      return launch_wgmma<TO, 128, true>(int4_wgmma_kernel<TO, 128>, x, wp, xs, ws, out, part, arrivals, M, N, K,
                                         splits, s);
    case kRouteWgmma256:
      return launch_wgmma<TO, 256, true>(int4_wgmma_kernel<TO, 256>, x, wp, xs, ws, out, part, arrivals, M, N, K,
                                         splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (M, K) int8; w_packed: (N / 2, K) int8 in the pack_int4_rows layout;
// xs: (M,) fp32; ws: (N,) fp32; out: (M, N) in `dtype`. All contiguous and
// 16-byte aligned; N % 128 == 0, K % 16 == 0. `route`, `splits` and (a
// decode route) `warps` a block as the wrapper chose them
// (int4_matmul.route): with splits > 1, part holds the
// route's partial tiles (int4_matmul.split_scratch_ints) and arrivals one
// zeroed int32 an output tile.
extern "C" int mojo_int4_matmul(const void* x, const void* w_packed, const void* xs, const void* ws, void* out,
                                void* part, void* arrivals, int M, int N, int K, int route, int splits, int warps,
                                int dtype, void* stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (N % 128 != 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, TO, {
    rc = dispatch_route<TO>(route, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_packed),
                            static_cast<const float*>(xs), static_cast<const float*>(ws), static_cast<TO*>(out),
                            static_cast<int*>(part), static_cast<int*>(arrivals), M, N, K, splits, warps, s);
  });
  return rc;
}
