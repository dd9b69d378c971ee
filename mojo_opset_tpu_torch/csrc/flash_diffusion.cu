// Kernel O: dense attention under an arbitrary boolean keep-mask, forward, dq
// and dk/dv.
//
// Replaces the JAX package's backends/pallas/kernels/diffusion_vjp.py:289
// (flash_diffusion: _fwd_kernel :38, _dq_kernel :82, _dkv_kernel :115).
//
// Contract: q/o/do/dq (B, hq, Sq, D), k/v/dk/dv (B, hkv, Sk, D), contiguous,
// one dtype; query head h reads kv head h / (hq / hkv) (AABB). The keep-mask
// is bytes (0 = masked) addressed through four element strides over
// (B, hq, Sq, Sk): 0 on a broadcast axis, so JAX's (S, S) mask, a (B, 1, 1, S)
// key-padding mask and a full mask are all read in place. lse and delta are
// fp32 (B, hq, Sq). A row whose mask keeps no key gets lse = 1e30 and
// o = `empty` (0 for the training Function, NaN for SDPA's semantics); in the
// backward its pairs are all masked, so its dq is 0 and it adds nothing to
// dk/dv, whatever its delta.
//
// Bound on the H100: operations (QK and PV in the forward, 4 * D per kept
// pair and query head; 6 * D in dq, 8 * D in dk/dv). bf16 and fp16 run them
// on the tensor cores with kernel J's tiles (csrc/flash_tiles.cuh:
// mma.sync.m16n8k16, operands in the working type in shared memory fed by a
// two-stage cp.async ring, P and dS split into hi + lo to keep the fp32 TPU
// kernel's accuracy); fp32 keeps scalar FMAs, a route by dtype in the entry
// points (no exact fp32 tensor-core product). Left for later: wgmma with
// TMA-fed rings.
//
// Design: J's tiling, staging and products, shared through
// csrc/flash_tiles.cuh, with the mask in place of J's sequence and window
// arithmetic.
//   forward / dq: one block per (tile of 64 query rows, query head, batch),
//     the bf16 / fp16 route launching the last row tiles first (a
//     block-diffusion mask gives them the most keys). The block skips every key tile that keeps nothing (a
//     block-diffusion mask's upper blocks, a padded batch row's pad keys).
//     The fp32 route loads each tile's mask into shared memory and votes on
//     it. The bf16 / fp16 route first classifies 256 tiles at a time
//     (nothing, some or every pair kept: each warp reads whole tiles of the
//     mask, 16 bytes a load where its key stride is 1 and its rows 16-byte
//     aligned, and votes, with no barrier a tile), walks only the kept
//     ones, loads the byte mask tile into shared memory for the tiles it
//     keeps in part, and skips the per-cell test on those it keeps whole.
//     The forward keeps an fp32 online softmax. dq computes delta =
//     rowsum(do * o) for its rows (and writes it for dk/dv), recomputes
//     p = exp(s - lse), ds = p * (dp - delta) on the kept pairs, and
//     dq = scale * ds K.
//   dk/dv: one block per (tile of keys, kv head, batch); it loops over the
//     query tiles and over the group's query heads, reading each mask tile
//     in place (no transposed copy, no padded mask in HBM), skipping tiles
//     that keep nothing as above, and accumulating dk and dv
//     in registers: they are written once, in the input type, with no
//     atomics and no per-query-head partials (the TPU kernel's
//     (B * hq, Sk, D) fp32 partials summed outside, :283-284). The fp32
//     route takes KR = 64 keys for D <= 128 and 32 for D = 256. Every sum
//     runs in a fixed order, so dq, dk and dv repeat bit for bit.
#include "flash_tiles.cuh"

namespace {

using namespace mojo_flash;

struct DiffArgs {
  const unsigned char* mask;
  long long msb, msh, msq, msk;  // element strides of the mask over (B, hq, Sq, Sk)
  int B, hq, hkv, Sq, Sk;
  float scale;
};

// Load an (R x C) tile of the mask into ms, row-major: element (r, c) is
// m[(r0 + r) * sr + (c0 + c) * sc], 0 past r_lim rows or c_lim columns.
// ROW_FAST: neighbouring threads take neighbouring r (the dk/dv tile, whose
// rows are keys). Returns whether this thread loaded a kept pair.
template <int R, int C, bool ROW_FAST>
__device__ __forceinline__ int load_mask_tile(unsigned char* ms, const unsigned char* __restrict__ m, int r0,
                                              int r_lim, long long sr, int c0, int c_lim, long long sc) {
  int any = 0;
  for (int i = threadIdx.x; i < R * C; i += kThreads) {
    const int r = ROW_FAST ? i % R : i / C;
    const int c = ROW_FAST ? i / R : i % C;
    unsigned char keep = 0;
    if (r0 + r < r_lim && c0 + c < c_lim) keep = m[(r0 + r) * sr + (c0 + c) * sc] != 0;
    ms[r * C + c] = keep;
    any |= keep;
  }
  return any;
}

// -- forward --------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_diffusion_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           T* __restrict__ o, float* __restrict__ lse, float empty, DiffArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = blockIdx.x * kRows;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;  // (b, h, 0) as a row of (B * hq * Sq, D)
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;
  const unsigned char* mb = a.mask + b * a.msb + h * a.msh;

  extern __shared__ float mojo_smem[];
  float* q_s = mojo_smem;
  float* k_s = q_s + kRows * QS;
  float* v_s = k_s + kBK * QS;
  float* p_s = v_s + kBK * QS;
  __shared__ unsigned char mask_s[kRows * kBK];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  stage_rows<T, D>(q_s, q + row0 * D, i0, kRows, a.Sq, D, a.scale);

  float m[kTR], l[kTR], acc[kTR][DC];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < a.Sk; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s staged)
    const int any = load_mask_tile<kRows, kBK, false>(mask_s, mb, i0, a.Sq, a.msq, j0, a.Sk, a.msk);
    if (!__syncthreads_or(any)) continue;  // the tile keeps no pair
    stage_rows<T, D>(k_s, k + key0 * D, j0, kBK, a.Sk, D, 1.f);
    stage_rows<T, D>(v_s, v + key0 * D, j0, kBK, a.Sk, D, 1.f);
    __syncthreads();

    float s[kTR][kTC] = {};
    tile_scores<D, kTR>(s, q_s, k_s, rg, cg);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c)
        if (!mask_s[(rg * kTR + i) * kBK + cg + kCG * c]) s[i][c] = -INFINITY;
    online_softmax<D>(s, m, l, acc, p_s, rg, cg);
    __syncthreads();
    tile_accumulate<D, kTR>(acc, p_s, v_s, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = i0 + rg * kTR + i;
    if (row < a.Sq) {
      const int64_t off = row0 + row;
      const bool seen = l[i] > 0.f;
      const float inv = seen ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[off * D + cg + kCG * c] = mojo_from_float<T>(seen ? acc[i][c] * inv : empty);
      if (cg == 0) lse[off] = seen ? m[i] + logf(l[i]) : kEmptyLse;
    }
  }
}

// -- dq ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_diffusion_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                          T* __restrict__ dq, float* __restrict__ delta_out, DiffArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = blockIdx.x * kRows;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;
  const unsigned char* mb = a.mask + b * a.msb + h * a.msh;

  extern __shared__ float mojo_smem[];
  float* q_s = mojo_smem;
  float* do_s = q_s + kRows * QS;
  float* k_s = do_s + kRows * QS;
  float* v_s = k_s + kBK * QS;
  float* ds_s = v_s + kBK * QS;
  __shared__ unsigned char mask_s[kRows * kBK];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  stage_rows<T, D>(q_s, q + row0 * D, i0, kRows, a.Sq, D, a.scale);
  stage_rows<T, D>(do_s, dout + row0 * D, i0, kRows, a.Sq, D, 1.f);
  __syncthreads();

  // delta = rowsum(do * o) over this thread's D/8 columns, then its row group
  float row_lse[kTR], row_delta[kTR], acc[kTR][DC];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    const bool valid = i0 + r < a.Sq;
    const int64_t off = row0 + i0 + r;
    float part = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < DC; ++c) part += do_s[r * QS + cg + kCG * c] * mojo_to_float(o[off * D + cg + kCG * c]);
    }
#pragma unroll
    for (int s = 1; s < kCG; s <<= 1) part += __shfl_xor_sync(0xffffffffu, part, s);
    row_delta[i] = part;
    row_lse[i] = valid ? lse[off] : kEmptyLse;
    if (valid && cg == 0) delta_out[off] = part;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < a.Sk; j0 += kBK) {
    __syncthreads();
    const int any = load_mask_tile<kRows, kBK, false>(mask_s, mb, i0, a.Sq, a.msq, j0, a.Sk, a.msk);
    if (!__syncthreads_or(any)) continue;
    stage_rows<T, D>(k_s, k + key0 * D, j0, kBK, a.Sk, D, 1.f);
    stage_rows<T, D>(v_s, v + key0 * D, j0, kBK, a.Sk, D, 1.f);
    __syncthreads();

    // S = Q K^T and dP = dO V^T on this thread's 4 x 4 cells, then dS
    float s[kTR][kTC] = {}, dp[kTR][kTC] = {};
    tile_scores2<D, kTR>(s, dp, q_s, k_s, do_s, v_s, rg, cg);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const bool keep = mask_s[(rg * kTR + i) * kBK + cg + kCG * c];
        s[i][c] = keep ? expf(s[i][c] - row_lse[i]) * (dp[i][c] - row_delta[i]) : 0.f;
      }
    store_cells<kTR>(ds_s, s, rg, cg);
    __syncthreads();
    tile_accumulate<D, kTR>(acc, ds_s, k_s, rg, cg);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int row = i0 + rg * kTR + i;
    if (row < a.Sq) {
      const int64_t off = row0 + row;
#pragma unroll
      for (int c = 0; c < DC; ++c) dq[off * D + cg + kCG * c] = mojo_from_float<T>(acc[i][c] * a.scale);
    }
  }
}

// -- dk / dv ----------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_diffusion_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                           const T* __restrict__ dout, const float* __restrict__ lse,
                           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, DiffArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  constexpr int KR = dkv_rows<D>();         // keys of a block
  constexpr int TR = KR * kCG / kThreads;   // keys per thread
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int j0 = blockIdx.x * KR;
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;

  extern __shared__ float mojo_smem[];
  float* k_s = mojo_smem;
  float* v_s = k_s + KR * QS;
  float* q_s = v_s + KR * QS;
  float* do_s = q_s + kBK * QS;
  float* p_s = do_s + kBK * QS;  // P^T, then dS^T: (KR, kBK)
  __shared__ unsigned char mask_s[KR * kBK];  // the mask tile transposed: (key, query row)
  __shared__ float lse_s[kBK], delta_s[kBK];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  stage_rows<T, D>(k_s, k + key0 * D, j0, KR, a.Sk, D, 1.f);
  stage_rows<T, D>(v_s, v + key0 * D, j0, KR, a.Sk, D, 1.f);

  float dk_acc[TR][DC], dv_acc[TR][DC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int t0 = 0; t0 < a.Sq; t0 += kBK) {
    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;
      __syncthreads();  // the previous tile's q_s, do_s, p_s and mask_s are consumed (and k_s, v_s staged)
      // keys are the tile's rows: the mask's query and key strides swap places
      const int any = load_mask_tile<KR, kBK, true>(mask_s, a.mask + b * a.msb + h * a.msh, j0, a.Sk, a.msk, t0,
                                                    a.Sq, a.msq);
      if (!__syncthreads_or(any)) continue;
      stage_rows<T, D>(q_s, q + row0 * D, t0, kBK, a.Sq, D, a.scale);
      stage_rows<T, D>(do_s, dout + row0 * D, t0, kBK, a.Sq, D, 1.f);
      if (tid < kBK) {
        const int t = t0 + tid;
        lse_s[tid] = t < a.Sq ? lse[row0 + t] : kEmptyLse;
        delta_s[tid] = t < a.Sq ? delta[row0 + t] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this thread's TR keys x 4 query columns
      float s[TR][kTC] = {}, dp[TR][kTC] = {};
      tile_scores2<D, TR>(s, dp, k_s, q_s, v_s, do_s, rg, cg);
      // P^T into p_s, and dS^T kept in s for after the dV product
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int c = 0; c < kTC; ++c) {
          const int tt = cg + kCG * c;
          const bool keep = mask_s[(rg * TR + i) * kBK + tt];
          const float p = keep ? expf(s[i][c] - lse_s[tt]) : 0.f;
          p_s[(rg * TR + i) * kSS + tt] = p;
          s[i][c] = keep ? p * (dp[i][c] - delta_s[tt]) : 0.f;
        }
      __syncthreads();
      tile_accumulate<D, TR>(dv_acc, p_s, do_s, rg, cg);  // dV += P^T dO
      __syncthreads();
      store_cells<TR>(p_s, s, rg, cg);
      __syncthreads();
      tile_accumulate<D, TR>(dk_acc, p_s, q_s, rg, cg);  // dK += dS^T Q (q_s carries the softmax scale)
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = j0 + rg * TR + i;
    if (r < a.Sk) {
      const int64_t off = (key0 + r) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[off + cg + kCG * c] = mojo_from_float<T>(dk_acc[i][c]);
        dv[off + cg + kCG * c] = mojo_from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// -- tensor-core kernels (bf16 / fp16) --------------------------------------------

__device__ __forceinline__ bool has_zero_byte(unsigned x) { return ((x - 0x01010101u) & ~x & 0x80808080u) != 0; }

// Whether a mask tile's 16-byte column chunks are each one aligned load.
__device__ __forceinline__ bool mask_vec(const unsigned char* m, long long sr, long long sc) {
  return sc == 1 && sr % 16 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
}

// A tile of the mask: element (r, c) is m[(r0 + r) sr + (c0 + c) sc] != 0,
// masked past r_lim rows or c_lim columns; vec = mask_vec(m, sr, sc).
struct MaskTile {
  const unsigned char* m;
  long long sr, sc;
  int r0, r_lim, c0, c_lim;
  bool vec;
};

// 16-byte chunk i (row i / (C / 16)) of a tile C columns wide, into u as
// bytes; returns {it keeps a pair, it keeps every pair}, rows past r_lim
// (never written) counting as kept and columns past c_lim as masked.
template <int C>
__device__ __forceinline__ int2 mask_chunk(const MaskTile& t, int i, uint4& u) {
  const int r = i / (C / 16), c = t.c0 + (i % (C / 16)) * 16;
  u = make_uint4(0u, 0u, 0u, 0u);
  if (t.r0 + r >= t.r_lim) return make_int2(0, 1);
  const unsigned char* row = t.m + (t.r0 + r) * t.sr;
  if (t.vec && c + 16 <= t.c_lim) {
    u = *reinterpret_cast<const uint4*>(row + c);
  } else {
    unsigned char* b = reinterpret_cast<unsigned char*>(&u);
#pragma unroll
    for (int e = 0; e < 16; ++e) b[e] = c + e < t.c_lim && row[(c + e) * t.sc] != 0;
  }
  return make_int2((u.x | u.y | u.z | u.w) != 0,
                   !(has_zero_byte(u.x) || has_zero_byte(u.y) || has_zero_byte(u.z) || has_zero_byte(u.w)));
}

// An (R x C) tile into ms, rows at a pitch of C + 16 bytes, for the per-cell test.
template <int R, int C, int NTH>
__device__ __forceinline__ void load_mask_mma(unsigned char* ms, const MaskTile& t) {
  for (int i = threadIdx.x; i < R * C / 16; i += NTH) {
    uint4 u;
    mask_chunk<C>(t, i, u);
    *reinterpret_cast<uint4*>(ms + (i / (C / 16)) * (C + 16) + (i % (C / 16)) * 16) = u;
  }
}

constexpr int kScanTiles = 256;  // tiles a block classifies at a time

// The tiles of a forward / dq block: its rows against key tile t.
struct KeyTiles {
  MaskTile rows;  // c0 unused
  int width;
  __device__ __forceinline__ MaskTile at(int t) const {
    MaskTile m = rows;
    m.c0 = t * width;
    return m;
  }
};

// The items of a dk/dv block: item t is (query tile t / group, head
// kv_head0 + t % group) against the block's keys.
struct ItemTiles {
  const unsigned char* m;  // the batch row's mask
  long long msh, sr, sc;
  int kv_head0, group, rows, r_lim, c0, c_lim;
  __device__ __forceinline__ MaskTile at(int t) const {
    const unsigned char* mh = m + (kv_head0 + t % group) * msh;
    return MaskTile{mh, sr, sc, (t / group) * rows, r_lim, c0, c_lim, mask_vec(mh, sr, sc)};
  }
};

// Classify tiles [first, first + kScanTiles) of n into state: 0 keeps
// nothing, 1 some pairs, 2 every pair. Warp w takes tiles w, w + NW, ...;
// its lanes read a tile's (R x C) mask in 16-byte chunks, all in flight at
// once, and vote, so a tile that keeps nothing costs no barrier. Out of
// line and given plain values: it runs once per kScanTiles tiles, and
// inlined into a key loop it would add its registers to the accumulators'.
template <int R, int C, int NW, class Gen>
__device__ __noinline__ void scan_tiles(unsigned char* state, int first, int n, Gen gen) {
  constexpr int K = R * C / 16 / 32;  // chunks a lane
  static_assert(R * C % (16 * 32) == 0, "a warp's lanes split a tile's chunks evenly");
  __syncthreads();  // every thread has read the last window
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = first + warp; t < min(first + kScanTiles, n); t += NW) {
    const MaskTile mt = gen.at(t);
    int any = 0, all = 1;
    if (mt.vec && mt.c0 + C <= mt.c_lim) {  // every chunk one 16-byte load
      uint4 u[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k, r = mt.r0 + i / (C / 16);
        u[k] = r < mt.r_lim ? *reinterpret_cast<const uint4*>(mt.m + r * mt.sr + mt.c0 + (i % (C / 16)) * 16)
                            : make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int i = lane + 32 * k;
        any |= mt.r0 + i / (C / 16) < mt.r_lim && (u[k].x | u[k].y | u[k].z | u[k].w) != 0;
        all &= !(has_zero_byte(u[k].x) || has_zero_byte(u[k].y) || has_zero_byte(u[k].z) || has_zero_byte(u[k].w));
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < K; ++k) {
        uint4 u;
        const int2 f = mask_chunk<C>(mt, lane + 32 * k, u);
        any |= f.x;
        all &= f.y;
      }
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) state[t - first] = any ? (all ? 2 : 1) : 0;
  }
  __syncthreads();
}

// The tiles of a block's loop that keep a pair, classified kScanTiles at a
// time by scan_tiles. Every thread calls next() with the same i.
template <int R, int C, int NW, class Gen>
struct KeptTiles {
  unsigned char* state;  // kScanTiles bytes of shared memory
  int n;
  Gen gen;
  int w0 = -kScanTiles;

  // the first tile at or after i that keeps a pair (n: none)
  __device__ __forceinline__ int next(int i) {
    for (; i < n; ++i) {
      if (i >= w0 + kScanTiles) {
        scan_tiles<R, C, NW>(state, i, n, gen);
        w0 = i;
      }
      if (state[i - w0]) return i;
    }
    return n;
  }

  // tile i, of the window the last next() left, keeps every pair
  __device__ __forceinline__ bool full(int i) const { return state[i - w0] == 2; }
};

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_diffusion_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ o, float* __restrict__ lse, float empty, DiffArgs a) {
  constexpr int BK = mma_keys<D>(), P = D + 8, NTH = kMmaWarps * 32, MP = BK + 16;
  constexpr bool kQRegs = D <= 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;  // (b, h, 0) as a row of (B * hq * Sq, D)
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;
  const unsigned char* mb = a.mask + b * a.msb + h * a.msh;
  const bool vec = mask_vec(mb, a.msq, a.msk);

  T* q_s = reinterpret_cast<T*>(mojo_mma_smem);
  T* kv_s = q_s + kRows * P;  // ring stage st: K at kv_s + 2 st BK P, V after it
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(kv_s + 4 * BK * P);  // stage st at st kRows MP
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  cp_rows<D, kRows, NTH>(q_s, q, [&](int r) -> const T* { return i0 + r < a.Sq ? q + (row0 + i0 + r) * D : nullptr; });
  cp_async_commit();
  const int n_tiles = (a.Sk + BK - 1) / BK;
  __shared__ unsigned char state_s[kScanTiles];
  KeptTiles<kRows, BK, kMmaWarps, KeyTiles> kept{
      state_s, n_tiles, {MaskTile{mb, a.msq, a.msk, i0, a.Sq, 0, a.Sk, vec}, BK}};
  auto load_tile = [&](int j, int st) {
    T* ks = kv_s + st * 2 * BK * P;
    const int j0 = j * BK;
    cp_rows<D, BK, NTH>(ks, k, [&](int r) -> const T* { return j0 + r < a.Sk ? k + (key0 + j0 + r) * D : nullptr; });
    cp_rows<D, BK, NTH>(ks + BK * P, v,
                        [&](int r) -> const T* { return j0 + r < a.Sk ? v + (key0 + j0 + r) * D : nullptr; });
    if (!kept.full(j)) load_mask_mma<kRows, BK, NTH>(mask_s + st * kRows * MP, kept.gen.at(j));
  };
  int cur = kept.next(0);
  bool full = cur < n_tiles && kept.full(cur);
  if (cur < n_tiles) load_tile(cur, 0);
  cp_async_commit();

  FwdRows<T, D> f;
  f.init();
  unsigned qf[kQRegs ? D / 16 : 1][4];
  cp_async_wait<1>();
  __syncthreads();
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) frag_a<P>(qf[kc], q_s, 16 * warp, 16 * kc);
  }
  const float sl2 = a.scale * kLog2e;

  for (int it = 0; cur < n_tiles; ++it) {
    const int st = it & 1;
    const int next = kept.next(cur + 1);
    const bool full_next = next < n_tiles && kept.full(next);
    if (next < n_tiles) load_tile(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = kv_s + st * 2 * BK * P;
    const unsigned char* ms = mask_s + st * kRows * MP + (16 * warp + lane / 4) * MP;
    f.template tile<BK>(
        [&](int kc, unsigned (&fa)[4]) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) fa[e] = qf[kc][e];
          } else {
            frag_a<P>(fa, q_s, 16 * warp, 16 * kc);
          }
        },
        ks, ks + BK * P, sl2, full, [&](int hh, int c) { return ms[8 * hh * MP + c] != 0; });
    __syncthreads();
    cur = next;
    full = full_next;
  }
  cp_async_wait<0>();

  float inv[2], row_lse[2];
  bool seen[2];
  f.finish(inv, row_lse, seen);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = i0 + 16 * warp + lane / 4 + 8 * hh;
    if (r < a.Sq) {
      const int64_t off = row0 + r;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store_pair(o + off * D + 8 * n + 2 * (lane & 3), seen[hh] ? f.acc[n][2 * hh] * inv[hh] : empty,
                   seen[hh] ? f.acc[n][2 * hh + 1] * inv[hh] : empty);
      if ((lane & 3) == 0) lse[off] = row_lse[hh];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_diffusion_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                       T* __restrict__ dq, float* __restrict__ delta_out, DiffArgs a) {
  constexpr int BK = mma_keys<D>(), P = D + 8, NTH = kMmaWarps * 32, MP = BK + 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.hq / a.hkv);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;
  const unsigned char* mb = a.mask + b * a.msb + h * a.msh;
  const bool vec = mask_vec(mb, a.msq, a.msk);

  T* q_s = reinterpret_cast<T*>(mojo_mma_smem);
  T* do_s = q_s + kRows * P;
  T* kv_s = do_s + kRows * P;
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(kv_s + 4 * BK * P);
  __shared__ float lse_s[kRows], delta_s[kRows];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  cp_rows<D, kRows, NTH>(q_s, q, [&](int r) -> const T* { return i0 + r < a.Sq ? q + (row0 + i0 + r) * D : nullptr; });
  cp_rows<D, kRows, NTH>(do_s, dout,
                         [&](int r) -> const T* { return i0 + r < a.Sq ? dout + (row0 + i0 + r) * D : nullptr; });
  cp_async_commit();
  const int n_tiles = (a.Sk + BK - 1) / BK;
  __shared__ unsigned char state_s[kScanTiles];
  KeptTiles<kRows, BK, kMmaWarps, KeyTiles> kept{
      state_s, n_tiles, {MaskTile{mb, a.msq, a.msk, i0, a.Sq, 0, a.Sk, vec}, BK}};
  auto load_tile = [&](int j, int st) {
    T* ks = kv_s + st * 2 * BK * P;
    const int j0 = j * BK;
    cp_rows<D, BK, NTH>(ks, k, [&](int r) -> const T* { return j0 + r < a.Sk ? k + (key0 + j0 + r) * D : nullptr; });
    cp_rows<D, BK, NTH>(ks + BK * P, v,
                        [&](int r) -> const T* { return j0 + r < a.Sk ? v + (key0 + j0 + r) * D : nullptr; });
    if (!kept.full(j)) load_mask_mma<kRows, BK, NTH>(mask_s + st * kRows * MP, kept.gen.at(j));
  };
  {  // delta = rowsum(do * o): two threads a row, D / 2 columns each, added in one order
    const int r = tid >> 1, half = tid & 1;
    const bool valid = i0 + r < a.Sq;
    float part = 0.f;
    if (valid) {
      const int64_t off = (row0 + i0 + r) * D + half * (D / 2);
      for (int d = 0; d < D / 2; d += 8) {
        float fo[8], fd[8];
        mojo_load_row<T, 8>(o + off + d, fo);
        mojo_load_row<T, 8>(dout + off + d, fd);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += fd[e] * fo[e];
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      delta_s[r] = part;
      lse_s[r] = (valid ? lse[row0 + i0 + r] : kEmptyLse) * kLog2e;
      if (valid) delta_out[row0 + i0 + r] = part;
    }
  }

  int cur = kept.next(0);
  bool full = cur < n_tiles && kept.full(cur);
  if (cur < n_tiles) load_tile(cur, 0);
  cp_async_commit();

  float row_lse2[2], row_delta[2];
  float acc[D / 8][4];
  zero_frags(acc);
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row_lse2[hh] = lse_s[16 * warp + lane / 4 + 8 * hh];
    row_delta[hh] = delta_s[16 * warp + lane / 4 + 8 * hh];
  }
  const float sl2 = a.scale * kLog2e;

  for (int it = 0; cur < n_tiles; ++it) {
    const int st = it & 1;
    const int next = kept.next(cur + 1);
    const bool full_next = next < n_tiles && kept.full(next);
    if (next < n_tiles) load_tile(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = kv_s + st * 2 * BK * P;
    const unsigned char* ms = mask_s + st * kRows * MP + (16 * warp + lane / 4) * MP;
    dq_tile<T, D, BK>(
        acc, [&](int kc, unsigned (&fa)[4]) { frag_a<P>(fa, q_s, 16 * warp, 16 * kc); },
        [&](int kc, unsigned (&fa)[4]) { frag_a<P>(fa, do_s, 16 * warp, 16 * kc); }, ks, ks + BK * P, row_lse2,
        row_delta, sl2, full, [&](int hh, int c) { return ms[8 * hh * MP + c] != 0; });
    __syncthreads();
    cur = next;
    full = full_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = i0 + 16 * warp + lane / 4 + 8 * hh;
    if (r < a.Sq) {
      T* out = dq + (row0 + r) * D + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store_pair(out + 8 * n, acc[n][2 * hh] * a.scale, acc[n][2 * hh + 1] * a.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(dkv_warps<D>() * 32)
flash_diffusion_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dk, T* __restrict__ dv, DiffArgs a) {
  constexpr int NW = dkv_warps<D>(), NTH = NW * 32, P = D + 8, BQ = kMmaQ, KR = kMmaKeys, DH = D * 4 / NW;
  constexpr int MP = KR + 16;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.hq / a.hkv;
  const int j0 = blockIdx.x * KR;
  const int64_t key0 = (static_cast<int64_t>(b) * a.hkv + kvh) * a.Sk;

  T* k_s = reinterpret_cast<T*>(mojo_mma_smem);
  T* v_s = k_s + KR * P;
  T* qd_s = v_s + KR * P;  // ring stage st: Q at qd_s + 2 st BQ P, dO after it
  unsigned char* mask_s = reinterpret_cast<unsigned char*>(qd_s + 4 * BQ * P);  // (query row, key), stage st at st BQ MP
  __shared__ float lse_s[2][BQ], delta_s[2][BQ];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  cp_rows<D, KR, NTH>(k_s, k, [&](int r) -> const T* { return j0 + r < a.Sk ? k + (key0 + j0 + r) * D : nullptr; });
  cp_rows<D, KR, NTH>(v_s, v, [&](int r) -> const T* { return j0 + r < a.Sk ? v + (key0 + j0 + r) * D : nullptr; });
  cp_async_commit();
  const int n_items = (a.Sq + BQ - 1) / BQ * group;  // (query tile, head of the group)
  __shared__ unsigned char state_s[kScanTiles];
  KeptTiles<BQ, KR, NW, ItemTiles> kept{
      state_s, n_items, {a.mask + b * a.msb, a.msh, a.msq, a.msk, kvh * group, group, BQ, a.Sq, j0, a.Sk}};
  auto load_tile = [&](int i, int st) {
    const int t0 = (i / group) * BQ, h = kvh * group + i % group;
    const int64_t row0 = (static_cast<int64_t>(b) * a.hq + h) * a.Sq;
    T* qs = qd_s + st * 2 * BQ * P;
    cp_rows<D, BQ, NTH>(qs, q, [&](int r) -> const T* { return t0 + r < a.Sq ? q + (row0 + t0 + r) * D : nullptr; });
    cp_rows<D, BQ, NTH>(qs + BQ * P, dout,
                        [&](int r) -> const T* { return t0 + r < a.Sq ? dout + (row0 + t0 + r) * D : nullptr; });
    if (tid < BQ) {
      const int t = t0 + tid;
      lse_s[st][tid] = (t < a.Sq ? lse[row0 + t] : kEmptyLse) * kLog2e;
      delta_s[st][tid] = t < a.Sq ? delta[row0 + t] : 0.f;
    }
    if (!kept.full(i)) load_mask_mma<BQ, KR, NTH>(mask_s + st * BQ * MP, kept.gen.at(i));
  };
  int cur = kept.next(0);
  bool full = cur < n_items && kept.full(cur);
  if (cur < n_items) load_tile(cur, 0);
  cp_async_commit();

  const int kr0 = 16 * (warp % 4), d0 = (warp / 4) * DH;
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
  zero_frags(dk_acc);
  zero_frags(dv_acc);
  const float sl2 = a.scale * kLog2e;

  for (int it = 0; cur < n_items; ++it) {
    const int st = it & 1;
    const int next = kept.next(cur + 1);
    const bool full_next = next < n_items && kept.full(next);
    if (next < n_items) load_tile(next, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qs = qd_s + st * 2 * BQ * P;
    const unsigned char* ms = mask_s + st * BQ * MP + kr0 + lane / 4;
    dkv_tile<T, D, DH>(dk_acc, dv_acc, k_s, v_s, kr0, qs, qs + BQ * P, lse_s[st], delta_s[st], d0, sl2, full,
                       [&](int hh, int c) { return ms[c * MP + 8 * hh] != 0; });
    __syncthreads();
    cur = next;
    full = full_next;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kr = j0 + kr0 + lane / 4 + 8 * hh;
    if (kr < a.Sk) {
      const int64_t off = (key0 + kr) * D + d0 + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        store_pair(dk + off + 8 * n, dk_acc[n][2 * hh] * a.scale, dk_acc[n][2 * hh + 1] * a.scale);
        store_pair(dv + off + 8 * n, dv_acc[n][2 * hh], dv_acc[n][2 * hh + 1]);
      }
    }
  }
}

// -- launchers --------------------------------------------------------------------

// bf16 / fp16 take the tensor-core kernels, fp32 the scalar ones (a route by dtype)
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, float empty, const DiffArgs& a,
               cudaStream_t s) {
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.hq, a.B);
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = rows_smem_floats<D>(kRows, 1, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_diffusion_fwd_kernel<T, D>, smem)) return rc;
    flash_diffusion_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
        empty, a);
  } else {
    constexpr int BK = mma_keys<D>();
    constexpr size_t smem = (kRows + 4 * BK) * (D + 8) * sizeof(T) + 2 * kRows * (BK + 16);
    if (int rc = set_smem(flash_diffusion_fwd_mma<T, D>, smem)) return rc;
    flash_diffusion_fwd_mma<T, D><<<grid, kMmaWarps * 32, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse,
        empty, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              void* dq, float* delta, const DiffArgs& a, cudaStream_t s) {
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.hq, a.B);
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = rows_smem_floats<D>(kRows, 2, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_diffusion_dq_kernel<T, D>, smem)) return rc;
    flash_diffusion_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta, a);
  } else {
    constexpr int BK = mma_keys<D>();
    constexpr size_t smem = (2 * kRows + 4 * BK) * (D + 8) * sizeof(T) + 2 * kRows * (BK + 16);
    if (int rc = set_smem(flash_diffusion_dq_mma<T, D>, smem)) return rc;
    flash_diffusion_dq_mma<T, D><<<grid, kMmaWarps * 32, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, const DiffArgs& a, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    constexpr int KR = dkv_rows<D>();
    constexpr size_t smem = rows_smem_floats<D>(KR, 2, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_diffusion_dkv_kernel<T, D>, smem)) return rc;
    const dim3 grid((a.Sk + KR - 1) / KR, a.hkv, a.B);
    flash_diffusion_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  } else {
    constexpr size_t smem = (2 * kMmaKeys + 4 * kMmaQ) * (D + 8) * sizeof(T) + 2 * kMmaQ * (kMmaKeys + 16);
    if (int rc = set_smem(flash_diffusion_dkv_mma<T, D>, smem)) return rc;
    const dim3 grid((a.Sk + kMmaKeys - 1) / kMmaKeys, a.hkv, a.B);
    flash_diffusion_dkv_mma<T, D><<<grid, dkv_warps<D>() * 32, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int B, int hq, int hkv, int Sq, int Sk) {
  return B < 1 || B > 65535 || hkv < 1 || hq > 65535 || hq % hkv != 0 || Sq < 0 || Sk < 0;
}

DiffArgs make_args(const void* mask, long long msb, long long msh, long long msq, long long msk, int B, int hq,
                   int hkv, int Sq, int Sk, float scale) {
  return DiffArgs{static_cast<const unsigned char*>(mask), msb, msh, msq, msk, B, hq, hkv, Sq, Sk, scale};
}

}  // namespace

// q/o/do/dq (B, hq, Sq, D), k/v/dk/dv (B, hkv, Sk, D) contiguous in one dtype;
// mask bytes addressed by (msb, msh, msq, msk); lse/delta (B, hq, Sq) fp32.
// D in {64, 128, 256}. The trailing list of all three: B, hq, hkv, Sq, Sk, D,
// msb, msh, msq, msk, scale (the forward then `empty`), dtype.
extern "C" int mojo_flash_diffusion_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                                        void* lse, int B, int hq, int hkv, int Sq, int Sk, int hd, long long msb,
                                        long long msh, long long msq, long long msk, float scale, float empty,
                                        int dtype, void* stream) {
  if (bad_args(B, hq, hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) return static_cast<int>(cudaSuccess);
  const DiffArgs a = make_args(mask, msb, msh, msq, msk, B, hq, hkv, Sq, Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_fwd<T, D>(q, k, v, o, static_cast<float*>(lse), empty, a, s)));
  return rc;
}

extern "C" int mojo_flash_diffusion_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                       const void* lse, const void* mask, void* dq, void* delta, int B, int hq,
                                       int hkv, int Sq, int Sk, int hd, long long msb, long long msh, long long msq,
                                       long long msk, float scale, int dtype, void* stream) {
  if (bad_args(B, hq, hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (Sq == 0) return static_cast<int>(cudaSuccess);
  const DiffArgs a = make_args(mask, msb, msh, msq, msk, B, hq, hkv, Sq, Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_dq<T, D>(q, k, v, o, dout, static_cast<const float*>(lse), dq,
                                                      static_cast<float*>(delta), a, s)));
  return rc;
}

extern "C" int mojo_flash_diffusion_dkv(const void* q, const void* k, const void* v, const void* dout,
                                        const void* lse, const void* delta, const void* mask, void* dk, void* dv,
                                        int B, int hq, int hkv, int Sq, int Sk, int hd, long long msb,
                                        long long msh, long long msq, long long msk, float scale, int dtype,
                                        void* stream) {
  if (bad_args(B, hq, hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  if (Sk == 0) return static_cast<int>(cudaSuccess);
  const DiffArgs a = make_args(mask, msb, msh, msq, msk, B, hq, hkv, Sq, Sk, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_dkv<T, D>(q, k, v, dout, static_cast<const float*>(lse),
                                                       static_cast<const float*>(delta), dk, dv, a, s)));
  return rc;
}
