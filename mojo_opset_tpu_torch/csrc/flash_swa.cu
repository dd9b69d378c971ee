// Kernel J: trainable varlen GQA/SWA flash attention, forward, dq and dk/dv.
//
// Replaces the JAX package's backends/pallas/kernels/flash_vjp.py:462
// (flash_swa: _fwd_kernel :124, _dq_kernel :184, _dkv_kernel :231).
//
// Contract (flash_vjp.py:50-101): packed q (Tq, hq, D), k/v (Tk, hkv, D),
// int32 cu_q/cu_k of B + 1. Row t belongs to the last sequence b with
// cu[b] <= t (clamped to [0, B-1], found by binary search: no batch limit);
// q_abs = kv_len[b] - q_len[b] + (t - cu_q[b]), k_pos = j - cu_k[b]. A row
// sees the keys of its sequence and, when causal, k_pos <= q_abs and (with
// a window) q_abs <= k_pos + lws or k_pos < gws (-1: no window). Query head
// h reads kv head h / group (AABB) or h % hkv (ABAB). lse is fp32
// (Tq, hq); a row that sees no key gets o = 0 and lse = 1e30.
//
// Bound on the H100: operations (QK and PV in the forward, 4 * D per
// visible pair and head; 6 * D in dq, 8 * D in dk/dv). bf16 and fp16 run
// them on the tensor cores (mma.sync.m16n8k16 with fp32 sums, operands in
// the working type in shared memory, fed by a two-stage cp.async ring,
// P and dS split into hi + lo so the products stay at the fp32 TPU
// kernel's accuracy: csrc/flash_tiles.cuh says why). The forward stages Q
// in the ring's second stage at D <= 128, whose fragments it holds in
// registers, so 3 blocks share an SM. fp32 keeps scalar FMAs (no exact
// fp32 tensor-core product; no model of the repo trains in fp32): a route
// by dtype in the entry points, not a fallback. Left for later: wgmma with
// TMA-fed K/V rings and warp specialisation.
//
// Design. The packed (T, H, D) rows are indexed in place (no head-major
// copies). Each block derives its key (or query) range from its own rows'
// sequences and positions: the union of what they can see. So a tile never
// walks keys of other sequences, or keys above the causal diagonal or below
// a local window, whether cu_q and cu_k are one vector or not; the exact
// mask is applied to every pair of a tile that not every row keeps whole
// (the block also finds the range that all its rows keep: below the causal
// diagonal, inside every row's window).
//   forward / dq: one block per (tile of 64 rows, kv head), the bf16 /
//     fp16 route launching the tiles with the most keys first. A row is a
//     (token, query head of the kv head's group) pair, 64 / group tokens a
//     tile (a ragged 63 rows at group 7), so each staged K/V tile serves
//     the whole group (a group over 64 heads, 71/1 MQA, in chunks of at
//     most 64 heads, one more grid dimension: SwaArgs gsize, chunks; dk/dv
//     walks every head of the group in one block whatever its size). The forward keeps an fp32 online softmax. dq
//     recomputes p = exp(s - lse), computes delta = rowsum(do * o) for its
//     rows (and writes it for dk/dv), ds = p * (dp - delta),
//     dq = scale * ds K.
//   dk/dv: one block per (tile of keys, kv head); it loops over the query
//     tokens that can see its keys, a tile at a time, and over the group's
//     query heads, accumulating dk and dv in registers: they are written
//     once, in the input type, with no atomics and no per-q-head partial
//     buffer (the TPU kernel's (hq, Tk, D) fp32 partials, summed outside,
//     :440-452). Every sum runs in a fixed order: dq, dk, dv repeat bit for
//     bit. The fp32 route takes KR = 64 keys for D <= 128 and 32 for
//     D = 256 (two (rows x D/8) accumulators in registers).
// The tiling, staging and products are csrc/flash_tiles.cuh's, shared with
// kernel O; this file keeps the sequence and window arithmetic.
#include <climits>

#include "flash_tiles.cuh"

namespace {

using namespace mojo_flash;

struct SwaArgs {
  const int* cu_q;
  const int* cu_k;
  int B, Tq, Tk, hq, hkv;
  float scale;
  int causal, lws, gws, abab;
  int gsize, chunks;  // forward / dq: a kv head's group in `chunks` tiles of at most gsize (<= 64) heads
};

// the last b in [0, B-1] with cu[b] <= t (0 when t < cu[1])
__device__ __forceinline__ int swa_seg(const int* __restrict__ cu, int B, int t) {
  int lo = 0, hi = B - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cu[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// padding rows carry seg -2 and padding keys seg -1, so they never match
__device__ __forceinline__ bool swa_keep(int qseg, int qabs, int kseg, int kpos, const SwaArgs& a) {
  if (qseg != kseg) return false;
  if (!a.causal) return true;
  if (qabs < kpos) return false;
  if (a.lws < 0 && a.gws < 0) return true;
  return (a.lws >= 0 && qabs <= kpos + a.lws) || (a.gws >= 0 && kpos < a.gws);
}

__device__ __forceinline__ int swa_head(int g, int kvh, int group, const SwaArgs& a) {
  return a.abab ? g * a.hkv + kvh : kvh * group + g;
}

// Sequence and absolute position of query token t, and the keys
// [lo, hi) it can see (lo >= hi: none).
__device__ __forceinline__ void swa_row_meta(int t, const SwaArgs& a, int& seg, int& qabs, int& lo, int& hi) {
  const int b = swa_seg(a.cu_q, a.B, t);
  const int qs = a.cu_q[b], ks = a.cu_k[b];
  seg = b;
  qabs = (a.cu_k[b + 1] - ks) - (a.cu_q[b + 1] - qs) + (t - qs);
  lo = b == 0 ? 0 : ks;
  hi = b == a.B - 1 ? a.Tk : a.cu_k[b + 1];
  if (a.causal) {
    hi = min(hi, ks + qabs + 1);
    if (a.lws >= 0 && a.gws < 0) lo = max(lo, ks + qabs - a.lws);
  }
}

// Sequence and position of key j, and the query tokens [lo, hi) that can see it.
__device__ __forceinline__ void swa_key_meta(int j, const SwaArgs& a, int& seg, int& kpos, int& lo, int& hi) {
  const int b = swa_seg(a.cu_k, a.B, j);
  const int qs = a.cu_q[b];
  seg = b;
  kpos = j - a.cu_k[b];
  lo = b == 0 ? 0 : qs;
  hi = b == a.B - 1 ? a.Tq : a.cu_q[b + 1];
  if (a.causal) {
    // q_abs(t) = t + off; visible when q_abs >= kpos (and, local only, q_abs <= kpos + lws)
    const int off = (a.cu_k[b + 1] - a.cu_k[b]) - (a.cu_q[b + 1] - qs) - qs;
    lo = max(lo, kpos - off);
    if (a.lws >= 0 && a.gws < 0) hi = min(hi, kpos + a.lws - off + 1);
  }
}

// Keys [flo, fhi) of swa_row_meta's [lo, hi) that a row of sequence seg at
// q_abs keeps every one of: all of it without a global window; with one,
// the local window's part, or (no local window) the global window's keys.
__device__ __forceinline__ void swa_row_full(const SwaArgs& a, int seg, int qabs, int lo, int hi, int& flo, int& fhi) {
  flo = lo;
  fhi = hi;
  if (!a.causal || a.gws < 0) return;
  const int ks = a.cu_k[seg];
  if (a.lws >= 0) flo = max(lo, ks + qabs - a.lws);
  else fhi = min(hi, ks + a.gws);
}

// Query tokens [flo, fhi) of swa_key_meta's [lo, hi) that all keep a key
// of sequence seg at kpos (the same three cases, seen from the key).
__device__ __forceinline__ void swa_key_full(const SwaArgs& a, int seg, int kpos, int lo, int hi, int& flo, int& fhi) {
  flo = lo;
  fhi = hi;
  if (!a.causal || a.gws < 0 || kpos < a.gws) return;
  if (a.lws < 0) {
    fhi = flo;
    return;
  }
  const int qs = a.cu_q[seg];
  const int off = (a.cu_k[seg + 1] - a.cu_k[seg]) - (a.cu_q[seg + 1] - qs) - qs;
  fhi = min(hi, kpos + a.lws - off + 1);
}

// row r of a forward / dq tile (tokens of gn heads from g0 of the group) as a row of q
__device__ __forceinline__ int64_t swa_row(int r, int tok0, int kvh, int g0, int gn, const SwaArgs& a) {
  return static_cast<int64_t>(tok0 + r / gn) * a.hq + swa_head(g0 + r % gn, kvh, a.hq / a.hkv, a);
}

// -- forward --------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, SwaArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  const int kvh = blockIdx.y / a.chunks;
  const int group = a.hq / a.hkv;
  const int g0 = (blockIdx.y % a.chunks) * a.gsize;  // the tile's heads: g0 .. g0 + gn - 1 of the group
  const int gn = min(a.gsize, group - g0);
  const int tpt = kRows / a.gsize;  // tokens per tile
  const int tok0 = blockIdx.x * tpt;
  const int n_tok = min(tpt, a.Tq - tok0);
  const int n_rows = n_tok * gn;

  extern __shared__ float mojo_smem[];
  float* q_s = mojo_smem;
  float* k_s = q_s + kRows * QS;
  float* v_s = k_s + kBK * QS;
  float* p_s = v_s + kBK * QS;
  __shared__ int tok_seg[kRows], tok_abs[kRows], key_seg[kBK], key_pos[kBK], range_s[2];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  if (tid == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < n_tok) {
    int seg, qabs, lo, hi;
    swa_row_meta(tok0 + tid, a, seg, qabs, lo, hi);
    tok_seg[tid] = seg;
    tok_abs[tid] = qabs;
    if (lo < hi) {
      atomicMin(&range_s[0], lo);
      atomicMax(&range_s[1], hi);
    }
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float val = 0.f;
    if (r < n_rows) {
      const int h = swa_head(g0 + r % gn, kvh, group, a);
      val = mojo_to_float(q[(static_cast<int64_t>(tok0 + r / gn) * a.hq + h) * D + d]) * a.scale;
    }
    q_s[r * QS + d] = val;
  }
  __syncthreads();

  float m[kTR], l[kTR], acc[kTR][DC];
  int row_seg[kTR], row_abs[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    row_seg[i] = r < n_rows ? tok_seg[r / gn] : -2;
    row_abs[i] = r < n_rows ? tok_abs[r / gn] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int k_lo = range_s[0], k_hi = range_s[1];

  for (int j0 = k_lo; j0 < k_hi; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kBK) {
      const int j = j0 + tid;
      int seg = -1, kpos = 0, lo, hi;
      if (j < k_hi) swa_key_meta(j, a, seg, kpos, lo, hi);
      key_seg[tid] = seg;
      key_pos[tid] = kpos;
    }
    stage_rows<T, D>(k_s, k + kvh * D, j0, kBK, k_hi, static_cast<int64_t>(a.hkv) * D, 1.f);
    stage_rows<T, D>(v_s, v + kvh * D, j0, kBK, k_hi, static_cast<int64_t>(a.hkv) * D, 1.f);
    __syncthreads();

    float s[kTR][kTC] = {};
    tile_scores<D, kTR>(s, q_s, k_s, rg, cg);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int jj = cg + kCG * c;
        if (!swa_keep(row_seg[i], row_abs[i], key_seg[jj], key_pos[jj], a)) s[i][c] = -INFINITY;
      }
    online_softmax<D>(s, m, l, acc, p_s, rg, cg);
    __syncthreads();
    tile_accumulate<D, kTR>(acc, p_s, v_s, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    if (r < n_rows) {
      const int64_t row = static_cast<int64_t>(tok0 + r / gn) * a.hq + swa_head(g0 + r % gn, kvh, group, a);
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[row * D + cg + kCG * c] = mojo_from_float<T>(acc[i][c] * inv);
      if (cg == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : kEmptyLse;
    }
  }
}

// -- dq ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_swa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, float* __restrict__ delta_out, SwaArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  const int kvh = blockIdx.y / a.chunks;
  const int group = a.hq / a.hkv;
  const int g0 = (blockIdx.y % a.chunks) * a.gsize;  // the tile's heads: g0 .. g0 + gn - 1 of the group
  const int gn = min(a.gsize, group - g0);
  const int tpt = kRows / a.gsize;
  const int tok0 = blockIdx.x * tpt;
  const int n_tok = min(tpt, a.Tq - tok0);
  const int n_rows = n_tok * gn;

  extern __shared__ float mojo_smem[];
  float* q_s = mojo_smem;
  float* do_s = q_s + kRows * QS;
  float* k_s = do_s + kRows * QS;
  float* v_s = k_s + kBK * QS;
  float* ds_s = v_s + kBK * QS;
  __shared__ int tok_seg[kRows], tok_abs[kRows], key_seg[kBK], key_pos[kBK], range_s[2];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  if (tid == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < n_tok) {
    int seg, qabs, lo, hi;
    swa_row_meta(tok0 + tid, a, seg, qabs, lo, hi);
    tok_seg[tid] = seg;
    tok_abs[tid] = qabs;
    if (lo < hi) {
      atomicMin(&range_s[0], lo);
      atomicMax(&range_s[1], hi);
    }
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float qv = 0.f, dv = 0.f;
    if (r < n_rows) {
      const int64_t off = (static_cast<int64_t>(tok0 + r / gn) * a.hq + swa_head(g0 + r % gn, kvh, group, a)) * D + d;
      qv = mojo_to_float(q[off]) * a.scale;
      dv = mojo_to_float(dout[off]);
    }
    q_s[r * QS + d] = qv;
    do_s[r * QS + d] = dv;
  }
  __syncthreads();

  // delta = rowsum(do * o) over this thread's D/8 columns, then its row group
  float row_lse[kTR], row_delta[kTR], acc[kTR][DC];
  int row_seg[kTR], row_abs[kTR];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    const bool valid = r < n_rows;
    const int64_t row = valid ? static_cast<int64_t>(tok0 + r / gn) * a.hq + swa_head(g0 + r % gn, kvh, group, a) : 0;
    float part = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < DC; ++c) part += do_s[r * QS + cg + kCG * c] * mojo_to_float(o[row * D + cg + kCG * c]);
    }
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    row_delta[i] = part;
    row_lse[i] = valid ? lse[row] : kEmptyLse;
    if (valid && cg == 0) delta_out[row] = part;
    row_seg[i] = valid ? tok_seg[r / gn] : -2;
    row_abs[i] = valid ? tok_abs[r / gn] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int k_lo = range_s[0], k_hi = range_s[1];

  for (int j0 = k_lo; j0 < k_hi; j0 += kBK) {
    __syncthreads();
    if (tid < kBK) {
      const int j = j0 + tid;
      int seg = -1, kpos = 0, lo, hi;
      if (j < k_hi) swa_key_meta(j, a, seg, kpos, lo, hi);
      key_seg[tid] = seg;
      key_pos[tid] = kpos;
    }
    stage_rows<T, D>(k_s, k + kvh * D, j0, kBK, k_hi, static_cast<int64_t>(a.hkv) * D, 1.f);
    stage_rows<T, D>(v_s, v + kvh * D, j0, kBK, k_hi, static_cast<int64_t>(a.hkv) * D, 1.f);
    __syncthreads();

    // S = Q K^T and dP = dO V^T on this thread's 4 x 4 cells, then dS
    float s[kTR][kTC] = {}, dp[kTR][kTC] = {};
    tile_scores2<D, kTR>(s, dp, q_s, k_s, do_s, v_s, rg, cg);
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        const int jj = cg + kCG * c;
        const bool keep = swa_keep(row_seg[i], row_abs[i], key_seg[jj], key_pos[jj], a);
        const float p = keep ? expf(s[i][c] - row_lse[i]) : 0.f;
        s[i][c] = p * (dp[i][c] - row_delta[i]);
      }
    store_cells<kTR>(ds_s, s, rg, cg);
    __syncthreads();
    tile_accumulate<D, kTR>(acc, ds_s, k_s, rg, cg);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = rg * kTR + i;
    if (r < n_rows) {
      const int64_t row = static_cast<int64_t>(tok0 + r / gn) * a.hq + swa_head(g0 + r % gn, kvh, group, a);
#pragma unroll
      for (int c = 0; c < DC; ++c) dq[row * D + cg + kCG * c] = mojo_from_float<T>(acc[i][c] * a.scale);
    }
  }
}

// -- dk / dv ----------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_swa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, SwaArgs a) {
  constexpr int QS = D + 1;
  constexpr int DC = D / kCG;
  constexpr int KR = dkv_rows<D>();         // keys of a block
  constexpr int TR = KR * kCG / kThreads;   // keys per thread
  const int kvh = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int key0 = blockIdx.x * KR;
  const int n_keys = min(KR, a.Tk - key0);

  extern __shared__ float mojo_smem[];
  float* k_s = mojo_smem;
  float* v_s = k_s + KR * QS;
  float* q_s = v_s + KR * QS;
  float* do_s = q_s + kBK * QS;
  float* p_s = do_s + kBK * QS;  // P^T, then dS^T: (KR, kBK)
  __shared__ int key_seg[kRows], key_pos[kRows], tok_seg[kBK], tok_abs[kBK], range_s[2];
  __shared__ float lse_s[kBK], delta_s[kBK];

  const int tid = threadIdx.x;
  const int rg = tid / kCG;
  const int cg = tid % kCG;
  if (tid == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < KR) {
    int seg = -1, kpos = 0, lo, hi;
    if (tid < n_keys) {
      swa_key_meta(key0 + tid, a, seg, kpos, lo, hi);
      if (lo < hi) {
        atomicMin(&range_s[0], lo);
        atomicMax(&range_s[1], hi);
      }
    }
    key_seg[tid] = seg;
    key_pos[tid] = kpos;
  }
  stage_rows<T, D>(k_s, k + kvh * D, key0, KR, a.Tk, static_cast<int64_t>(a.hkv) * D, 1.f);
  stage_rows<T, D>(v_s, v + kvh * D, key0, KR, a.Tk, static_cast<int64_t>(a.hkv) * D, 1.f);
  __syncthreads();

  float dk_acc[TR][DC], dv_acc[TR][DC];
  int my_seg[TR], my_pos[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    my_seg[i] = key_seg[rg * TR + i];
    my_pos[i] = key_pos[rg * TR + i];
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }
  const int q_lo = range_s[0], q_hi = range_s[1];

  for (int t0 = q_lo; t0 < q_hi; t0 += kBK) {
    __syncthreads();  // the previous query tile's metadata is consumed
    if (tid < kBK) {
      const int t = t0 + tid;
      int seg = -2, qabs = 0, lo, hi;
      if (t < q_hi) swa_row_meta(t, a, seg, qabs, lo, hi);
      tok_seg[tid] = seg;
      tok_abs[tid] = qabs;
    }
    for (int g = 0; g < group; ++g) {
      const int h = swa_head(g, kvh, group, a);
      __syncthreads();  // q_s, do_s, p_s of the previous head are consumed
      stage_rows<T, D>(q_s, q + h * D, t0, kBK, q_hi, static_cast<int64_t>(a.hq) * D, a.scale);
      stage_rows<T, D>(do_s, dout + h * D, t0, kBK, q_hi, static_cast<int64_t>(a.hq) * D, 1.f);
      if (tid < kBK) {
        const int t = t0 + tid;
        lse_s[tid] = t < q_hi ? lse[static_cast<int64_t>(t) * a.hq + h] : kEmptyLse;
        delta_s[tid] = t < q_hi ? delta[static_cast<int64_t>(t) * a.hq + h] : 0.f;
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
          const bool keep = swa_keep(tok_seg[tt], tok_abs[tt], my_seg[i], my_pos[i], a);
          const float p = keep ? expf(s[i][c] - lse_s[tt]) : 0.f;
          p_s[(rg * TR + i) * kSS + tt] = p;
          s[i][c] = p * (dp[i][c] - delta_s[tt]);
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
    const int r = rg * TR + i;
    if (r < n_keys) {
      const int64_t row = (static_cast<int64_t>(key0 + r) * a.hkv + kvh) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[row + cg + kCG * c] = mojo_from_float<T>(dk_acc[i][c]);
        dv[row + cg + kCG * c] = mojo_from_float<T>(dv_acc[i][c]);
      }
    }
  }
}

// -- tensor-core kernels (bf16 / fp16) --------------------------------------------

// The forward's shared memory, in elements: the K/V ring of two stages and
// Q's 64 rows. With Q's fragments in registers (D <= 128) Q is staged in
// ring stage 1, free until tile 1 loads: 69.6 KB at D 128, room for 3
// blocks an SM (their registers held to 168 by the launch bounds).
template <int D>
__host__ __device__ constexpr int fwd_q_offset() {
  return (D <= 128 ? 2 : 4) * mma_keys<D>() * (D + 8);
}
template <int D>
__host__ __device__ constexpr int fwd_smem_elems() {
  return D <= 128 ? 4 * mma_keys<D>() * (D + 8) : (4 * mma_keys<D>() + kRows) * (D + 8);
}
template <int D>
__host__ __device__ constexpr int fwd_blocks() {
  return D <= 128 ? 3 : 1;
}

// A forward / dq block's tokens: their sequences and positions into tok_seg,
// tok_abs, and range_s = {first key any row sees, one past the last, first
// key every row keeps, one past the last of those}.
__device__ __forceinline__ void swa_block_rows(int tok0, int n_tok, const SwaArgs& a, int* tok_seg, int* tok_abs,
                                               int* range_s) {
  if (threadIdx.x == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
    range_s[2] = INT_MIN;
    range_s[3] = INT_MAX;
  }
  __syncthreads();
  if (threadIdx.x < n_tok) {
    int seg, qabs, lo, hi, flo, fhi;
    swa_row_meta(tok0 + threadIdx.x, a, seg, qabs, lo, hi);
    swa_row_full(a, seg, qabs, lo, hi, flo, fhi);
    tok_seg[threadIdx.x] = seg;
    tok_abs[threadIdx.x] = qabs;
    if (lo < hi) {
      atomicMin(&range_s[0], lo);
      atomicMax(&range_s[1], hi);
    }
    atomicMax(&range_s[2], flo);
    atomicMin(&range_s[3], fhi);
  }
  __syncthreads();
}

// Stage key tile j0 (BK keys below k_hi) of kv head kvh into K and V rows at
// ks, ks + BK (D + 8), and its keys' sequences and positions.
template <int D, int BK, int NTH, typename T>
__device__ __forceinline__ void swa_load_keys(T* ks, const T* k, const T* v, int j0, int k_hi, int kvh,
                                               const SwaArgs& a, int* key_seg, int* key_pos) {
  const int64_t stride = static_cast<int64_t>(a.hkv) * D;
  cp_rows<D, BK, NTH>(ks, k, [&](int r) -> const T* { return j0 + r < k_hi ? k + (j0 + r) * stride + kvh * D : nullptr; });
  cp_rows<D, BK, NTH>(ks + BK * (D + 8), v,
                      [&](int r) -> const T* { return j0 + r < k_hi ? v + (j0 + r) * stride + kvh * D : nullptr; });
  if (threadIdx.x < BK) {
    const int j = j0 + threadIdx.x;
    int seg = -1, kpos = 0, lo, hi;
    if (j < k_hi) swa_key_meta(j, a, seg, kpos, lo, hi);
    key_seg[threadIdx.x] = seg;
    key_pos[threadIdx.x] = kpos;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32, fwd_blocks<D>())
flash_swa_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, SwaArgs a) {
  constexpr int BK = mma_keys<D>(), P = D + 8, NTH = kMmaWarps * 32;
  constexpr bool kQRegs = D <= 128;  // Q's fragments in registers for the whole key loop
  const int kvh = blockIdx.y / a.chunks;
  const int group = a.hq / a.hkv;
  const int g0 = (blockIdx.y % a.chunks) * a.gsize;  // the tile's heads: g0 .. g0 + gn - 1 of the group
  const int gn = min(a.gsize, group - g0);
  const int tpt = kRows / a.gsize;
  const int tok0 = (gridDim.x - 1 - blockIdx.x) * tpt;  // the causal tiles with the most keys first
  const int n_tok = min(tpt, a.Tq - tok0);
  const int n_rows = n_tok * gn;

  T* kv_s = reinterpret_cast<T*>(mojo_mma_smem);  // ring stage st: K at kv_s + 2 st BK P, V after it
  T* q_s = kv_s + fwd_q_offset<D>();
  __shared__ int tok_seg[kRows], tok_abs[kRows], key_seg[2][BK], key_pos[2][BK], range_s[4];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  cp_rows<D, kRows, NTH>(q_s, q, [&](int r) -> const T* {
    return r < n_rows ? q + swa_row(r, tok0, kvh, g0, gn, a) * D : nullptr;
  });
  cp_async_commit();
  swa_block_rows(tok0, n_tok, a, tok_seg, tok_abs, range_s);
  const int k_lo = range_s[0], k_hi = range_s[1], f_lo = range_s[2], f_hi = range_s[3];
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  if (n_tiles > 0) swa_load_keys<D, BK, NTH>(kv_s, k, v, k_lo, k_hi, kvh, a, key_seg[0], key_pos[0]);
  cp_async_commit();

  int row_seg[2], row_abs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    row_seg[h] = r < n_rows ? tok_seg[r / gn] : -2;
    row_abs[h] = r < n_rows ? tok_abs[r / gn] : 0;
  }
  FwdRows<T, D> f;
  f.init();
  unsigned qf[kQRegs ? D / 16 : 1][4];
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) frag_a<P>(qf[kc], q_s, 16 * warp, 16 * kc);
    __syncthreads();  // Q's rows are read: ring stage 1 takes tile 1
  }
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, j0 = k_lo + i * BK;
    if (i + 1 < n_tiles)
      swa_load_keys<D, BK, NTH>(kv_s + (st ^ 1) * 2 * BK * P, k, v, j0 + BK, k_hi, kvh, a, key_seg[st ^ 1],
                                 key_pos[st ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = kv_s + st * 2 * BK * P;
    f.template tile<BK>(
        [&](int kc, unsigned (&fa)[4]) {
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 4; ++e) fa[e] = qf[kc][e];
          } else {
            frag_a<P>(fa, q_s, 16 * warp, 16 * kc);
          }
        },
        ks, ks + BK * P, sl2, j0 >= f_lo && j0 + BK <= f_hi,
        [&](int h, int c) { return swa_keep(row_seg[h], row_abs[h], key_seg[st][c], key_pos[st][c], a); });
    __syncthreads();  // this stage is consumed before the next tile's copies overwrite it
  }

  float inv[2], row_lse[2];
  bool seen[2];
  f.finish(inv, row_lse, seen);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    if (r < n_rows) {
      const int64_t row = swa_row(r, tok0, kvh, g0, gn, a);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store_pair(o + row * D + 8 * n + 2 * (lane & 3), f.acc[n][2 * h] * inv[h], f.acc[n][2 * h + 1] * inv[h]);
      if ((lane & 3) == 0) lse[row] = row_lse[h];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_swa_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse, T* __restrict__ dq,
                 float* __restrict__ delta_out, SwaArgs a) {
  constexpr int BK = mma_keys<D>(), P = D + 8, NTH = kMmaWarps * 32;
  const int kvh = blockIdx.y / a.chunks;
  const int group = a.hq / a.hkv;
  const int g0 = (blockIdx.y % a.chunks) * a.gsize;  // the tile's heads: g0 .. g0 + gn - 1 of the group
  const int gn = min(a.gsize, group - g0);
  const int tpt = kRows / a.gsize;
  const int tok0 = (gridDim.x - 1 - blockIdx.x) * tpt;
  const int n_tok = min(tpt, a.Tq - tok0);
  const int n_rows = n_tok * gn;

  T* q_s = reinterpret_cast<T*>(mojo_mma_smem);
  T* do_s = q_s + kRows * P;
  T* kv_s = do_s + kRows * P;
  __shared__ int tok_seg[kRows], tok_abs[kRows], key_seg[2][BK], key_pos[2][BK], range_s[4];
  __shared__ float lse_s[kRows], delta_s[kRows];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto row_src = [&](const T* x) {
    return [=, &a](int r) -> const T* { return r < n_rows ? x + swa_row(r, tok0, kvh, g0, gn, a) * D : nullptr; };
  };
  cp_rows<D, kRows, NTH>(q_s, q, row_src(q));
  cp_rows<D, kRows, NTH>(do_s, dout, row_src(dout));
  cp_async_commit();
  swa_block_rows(tok0, n_tok, a, tok_seg, tok_abs, range_s);
  const int k_lo = range_s[0], k_hi = range_s[1], f_lo = range_s[2], f_hi = range_s[3];
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  if (n_tiles > 0) swa_load_keys<D, BK, NTH>(kv_s, k, v, k_lo, k_hi, kvh, a, key_seg[0], key_pos[0]);
  cp_async_commit();

  {  // delta = rowsum(do * o): two threads a row, D / 2 columns each, added in one order
    const int r = tid >> 1, half = tid & 1;
    const bool valid = r < n_rows;
    const int64_t row = valid ? swa_row(r, tok0, kvh, g0, gn, a) : 0;
    float part = 0.f;
    if (valid) {
      const int64_t off = row * D + half * (D / 2);
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
      lse_s[r] = (valid ? lse[row] : kEmptyLse) * kLog2e;
      if (valid) delta_out[row] = part;
    }
  }

  int row_seg[2], row_abs[2];
  float row_lse2[2], row_delta[2];
  float acc[D / 8][4];
  zero_frags(acc);
  cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    row_seg[h] = r < n_rows ? tok_seg[r / gn] : -2;
    row_abs[h] = r < n_rows ? tok_abs[r / gn] : 0;
    row_lse2[h] = lse_s[r];
    row_delta[h] = delta_s[r];
  }
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, j0 = k_lo + i * BK;
    if (i + 1 < n_tiles)
      swa_load_keys<D, BK, NTH>(kv_s + (st ^ 1) * 2 * BK * P, k, v, j0 + BK, k_hi, kvh, a, key_seg[st ^ 1],
                                 key_pos[st ^ 1]);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = kv_s + st * 2 * BK * P;
    dq_tile<T, D, BK>(
        acc, [&](int kc, unsigned (&fa)[4]) { frag_a<P>(fa, q_s, 16 * warp, 16 * kc); },
        [&](int kc, unsigned (&fa)[4]) { frag_a<P>(fa, do_s, 16 * warp, 16 * kc); }, ks, ks + BK * P, row_lse2,
        row_delta, sl2, j0 >= f_lo && j0 + BK <= f_hi,
        [&](int h, int c) { return swa_keep(row_seg[h], row_abs[h], key_seg[st][c], key_pos[st][c], a); });
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    if (r < n_rows) {
      const int64_t row = swa_row(r, tok0, kvh, g0, gn, a);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store_pair(dq + row * D + 8 * n + 2 * (lane & 3), acc[n][2 * h] * a.scale, acc[n][2 * h + 1] * a.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(dkv_warps<D>() * 32)
flash_swa_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, SwaArgs a) {
  constexpr int NW = dkv_warps<D>(), NTH = NW * 32, P = D + 8, BQ = kMmaQ, KR = kMmaKeys, DH = D * 4 / NW;
  const int kvh = blockIdx.y;
  const int group = a.hq / a.hkv;
  const int key0 = blockIdx.x * KR;
  const int n_keys = min(KR, a.Tk - key0);

  T* k_s = reinterpret_cast<T*>(mojo_mma_smem);
  T* v_s = k_s + KR * P;
  T* qd_s = v_s + KR * P;  // ring stage st: Q at qd_s + 2 st BQ P, dO after it
  __shared__ int key_seg[KR], key_pos[KR], tok_seg[2][BQ], tok_abs[2][BQ], range_s[4];
  __shared__ float lse_s[2][BQ], delta_s[2][BQ];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const int64_t kv_stride = static_cast<int64_t>(a.hkv) * D;
  cp_rows<D, KR, NTH>(k_s, k, [&](int r) -> const T* { return r < n_keys ? k + (key0 + r) * kv_stride + kvh * D : nullptr; });
  cp_rows<D, KR, NTH>(v_s, v, [&](int r) -> const T* { return r < n_keys ? v + (key0 + r) * kv_stride + kvh * D : nullptr; });
  cp_async_commit();
  if (tid == 0) {
    range_s[0] = INT_MAX;
    range_s[1] = INT_MIN;
    range_s[2] = INT_MIN;
    range_s[3] = INT_MAX;
  }
  __syncthreads();
  if (tid < KR) {
    int seg = -1, kpos = 0, lo, hi, flo, fhi;
    if (tid < n_keys) {
      swa_key_meta(key0 + tid, a, seg, kpos, lo, hi);
      swa_key_full(a, seg, kpos, lo, hi, flo, fhi);
      if (lo < hi) {
        atomicMin(&range_s[0], lo);
        atomicMax(&range_s[1], hi);
      }
      atomicMax(&range_s[2], flo);
      atomicMin(&range_s[3], fhi);
    }
    key_seg[tid] = seg;
    key_pos[tid] = kpos;
  }
  __syncthreads();
  const int q_lo = range_s[0], q_hi = range_s[1], f_lo = range_s[2], f_hi = range_s[3];
  const int n_items = (q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0) * group;  // (query tile, head of the group)

  auto load_item = [&](int i) {
    const int st = i & 1, t0 = q_lo + (i / group) * BQ, h = swa_head(i % group, kvh, group, a);
    T* qs = qd_s + st * 2 * BQ * P;
    const int64_t stride = static_cast<int64_t>(a.hq) * D;
    cp_rows<D, BQ, NTH>(qs, q, [&](int r) -> const T* { return t0 + r < q_hi ? q + (t0 + r) * stride + h * D : nullptr; });
    cp_rows<D, BQ, NTH>(qs + BQ * P, dout,
                        [&](int r) -> const T* { return t0 + r < q_hi ? dout + (t0 + r) * stride + h * D : nullptr; });
    if (tid < BQ) {
      const int t = t0 + tid;
      int seg = -2, qabs = 0, lo, hi;
      if (t < q_hi) swa_row_meta(t, a, seg, qabs, lo, hi);
      tok_seg[st][tid] = seg;
      tok_abs[st][tid] = qabs;
      lse_s[st][tid] = (t < q_hi ? lse[static_cast<int64_t>(t) * a.hq + h] : kEmptyLse) * kLog2e;
      delta_s[st][tid] = t < q_hi ? delta[static_cast<int64_t>(t) * a.hq + h] : 0.f;
    }
  };
  if (n_items > 0) load_item(0);
  cp_async_commit();

  const int kr0 = 16 * (warp % 4), d0 = (warp / 4) * DH;
  int my_seg[2], my_pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    my_seg[h] = key_seg[kr0 + lane / 4 + 8 * h];
    my_pos[h] = key_pos[kr0 + lane / 4 + 8 * h];
  }
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
  zero_frags(dk_acc);
  zero_frags(dv_acc);
  const float sl2 = a.scale * kLog2e;

  for (int i = 0; i < n_items; ++i) {
    const int st = i & 1, t0 = q_lo + (i / group) * BQ;
    if (i + 1 < n_items) load_item(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qs = qd_s + st * 2 * BQ * P;
    dkv_tile<T, D, DH>(dk_acc, dv_acc, k_s, v_s, kr0, qs, qs + BQ * P, lse_s[st], delta_s[st], d0, sl2,
                       t0 >= f_lo && t0 + BQ <= f_hi,
                       [&](int h, int c) { return swa_keep(tok_seg[st][c], tok_abs[st][c], my_seg[h], my_pos[h], a); });
    __syncthreads();
  }
  cp_async_wait<0>();  // with no query tile, K and V may still be landing

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = kr0 + lane / 4 + 8 * h;
    if (kr < n_keys) {
      const int64_t row = (static_cast<int64_t>(key0 + kr) * a.hkv + kvh) * D + d0 + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        store_pair(dk + row + 8 * n, dk_acc[n][2 * h] * a.scale, dk_acc[n][2 * h + 1] * a.scale);
        store_pair(dv + row + 8 * n, dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
      }
    }
  }
}

// -- launchers --------------------------------------------------------------------

// bf16 / fp16 take the tensor-core kernels, fp32 the scalar ones (a route by dtype)
template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, const SwaArgs& a,
               cudaStream_t s) {
  const int tpt = kRows / a.gsize;
  const dim3 grid((a.Tq + tpt - 1) / tpt, a.hkv * a.chunks);
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = rows_smem_floats<D>(kRows, 1, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_swa_fwd_kernel<T, D>, smem)) return rc;
    flash_swa_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                           static_cast<const T*>(v), static_cast<T*>(o), lse, a);
  } else {
    constexpr size_t smem = fwd_smem_elems<D>() * sizeof(T);
    if (int rc = set_smem(flash_swa_fwd_mma<T, D>, smem)) return rc;
    flash_swa_fwd_mma<T, D><<<grid, kMmaWarps * 32, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                               static_cast<const T*>(v), static_cast<T*>(o), lse, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              void* dq, float* delta, const SwaArgs& a, cudaStream_t s) {
  const int tpt = kRows / a.gsize;
  const dim3 grid((a.Tq + tpt - 1) / tpt, a.hkv * a.chunks);
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = rows_smem_floats<D>(kRows, 2, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_swa_dq_kernel<T, D>, smem)) return rc;
    flash_swa_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta, a);
  } else {
    constexpr size_t smem = (2 * kRows + 4 * mma_keys<D>()) * (D + 8) * sizeof(T);
    if (int rc = set_smem(flash_swa_dq_mma<T, D>, smem)) return rc;
    flash_swa_dq_mma<T, D><<<grid, kMmaWarps * 32, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, const SwaArgs& a, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>) {
    constexpr int KR = dkv_rows<D>();
    constexpr size_t smem = rows_smem_floats<D>(KR, 2, kBK, 2) * sizeof(float);
    if (int rc = set_smem(flash_swa_dkv_kernel<T, D>, smem)) return rc;
    const dim3 grid((a.Tk + KR - 1) / KR, a.hkv);
    flash_swa_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  } else {
    constexpr size_t smem = (2 * kMmaKeys + 4 * kMmaQ) * (D + 8) * sizeof(T);
    if (int rc = set_smem(flash_swa_dkv_mma<T, D>, smem)) return rc;
    const dim3 grid((a.Tk + kMmaKeys - 1) / kMmaKeys, a.hkv);
    flash_swa_dkv_mma<T, D><<<grid, dkv_warps<D>() * 32, smem, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
        lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int B, int hq, int hkv) {
  return B < 1 || hkv < 1 || hq % hkv != 0;
}

SwaArgs make_args(const void* cu_q, const void* cu_k, int B, int Tq, int Tk, int hq, int hkv, float scale, int causal,
                  int lws, int gws, int abab) {
  const int group = hq / hkv, chunks = (group + kRows - 1) / kRows;
  return SwaArgs{static_cast<const int*>(cu_q), static_cast<const int*>(cu_k), B, Tq, Tk, hq, hkv, scale, causal,
                 lws, gws, abab, (group + chunks - 1) / chunks, chunks};
}

}  // namespace

// q/o/do/dq (Tq, hq, D), k/v/dk/dv (Tk, hkv, D) contiguous in one dtype;
// cu_q/cu_k (B+1,) int32; lse/delta (Tq, hq) fp32. D in {64, 128, 256};
// any hq a multiple of hkv; lws, gws >= 0 or -1 (none). The trailing int list of all
// three: B, Tq, Tk, hq, hkv, D, scale, causal, lws, gws, abab, dtype.
extern "C" int mojo_flash_swa_fwd(const void* q, const void* k, const void* v, const void* cu_q, const void* cu_k,
                                  void* o, void* lse, int B, int Tq, int Tk, int hq, int hkv, int hd, float scale,
                                  int causal, int lws, int gws, int abab, int dtype, void* stream) {
  if (Tq <= 0) return static_cast<int>(cudaSuccess);
  if (bad_args(B, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const SwaArgs a = make_args(cu_q, cu_k, B, Tq, Tk, hq, hkv, scale, causal, lws, gws, abab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_fwd<T, D>(q, k, v, o, static_cast<float*>(lse), a, s)));
  return rc;
}

extern "C" int mojo_flash_swa_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                                 const void* lse, const void* cu_q, const void* cu_k, void* dq, void* delta, int B,
                                 int Tq, int Tk, int hq, int hkv, int hd, float scale, int causal, int lws, int gws,
                                 int abab, int dtype, void* stream) {
  if (Tq <= 0) return static_cast<int>(cudaSuccess);
  if (bad_args(B, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const SwaArgs a = make_args(cu_q, cu_k, B, Tq, Tk, hq, hkv, scale, causal, lws, gws, abab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_dq<T, D>(q, k, v, o, dout, static_cast<const float*>(lse), dq,
                                                static_cast<float*>(delta), a, s)));
  return rc;
}

extern "C" int mojo_flash_swa_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* cu_q, const void* cu_k, void* dk, void* dv, int B,
                                  int Tq, int Tk, int hq, int hkv, int hd, float scale, int causal, int lws, int gws,
                                  int abab, int dtype, void* stream) {
  if (Tk <= 0) return static_cast<int>(cudaSuccess);
  if (bad_args(B, hq, hkv)) return static_cast<int>(cudaErrorInvalidValue);
  const SwaArgs a = make_args(cu_q, cu_k, B, Tq, Tk, hq, hkv, scale, causal, lws, gws, abab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH(dtype, hd, rc = (launch_dkv<T, D>(q, k, v, dout, static_cast<const float*>(lse),
                                                 static_cast<const float*>(delta), dk, dv, a, s)));
  return rc;
}
