// Kernel C: one-token GQA decode over a paged KV cache.
//
// Replaces the JAX package's backends/pallas/kernels/paged_decode.py:260
// (paged_decode_gqa, body _decode_kernel :30).
//
// Bound on the H100: the bytes of K and V. Every cached row is read once
// per step and takes 4 * group FLOPs per element. At the main path's
// batch (B 4, Qwen3-4B's 32/8 heads, D 128) that is 3.4 MB, 1 us at
// 3.35 TB/s: the time is latency, the dependent page-table and row loads
// of each warp's walk, so the design spreads the walk over the whole card.
// Design (split-KV). The grid is (kv head x group chunk, batch row,
// split). A block serves up to 16 query heads of one kv head (a chunk of
// the group; G = 4 for groups <= 4) from each K/V row it loads, so K/V
// cross device memory once per chunk. The split count comes from the
// caller and depends on shapes only (B, Hkv, the chunks, the table's
// keys, the windows; backends/cuda/kernels/paged_decode.py split_count):
// one wave of two blocks an SM (the kernel holds two an SM), and one split
// once B x Hkv x chunks fills that wave. Each row's kept keys go to the
// splits in contiguous ranges of ceil(n_keys / splits) keys, rounded up to
// the block's 64-key step, computed on the device from the row's own
// seq_len, so short rows get short splits and no length is read on the
// host. Inside a block the 8 warps walk the range independently, 8 keys
// at a time (warp w takes keys lo + 64i + 8w .. + 7). Each warp copies its
// steps' K and V rows with cp.async into its own ring in shared memory,
// two steps ahead (one for rows over 256 bytes), so the row loads of later
// steps are in flight while it does this step's math from registers; the
// table entries of a step are loaded (lane k, key k) one step before its
// copies are issued, so no copy, and no math behind it, waits on a table
// load.
// Lanes split head_dim, and the warp keeps its own fp32 online softmax
// per head, as the TPU kernel does per block (:212-240). No block barrier
// stands inside the walk (a warp syncs only itself around its ring
// stages). The 8 partial scores of one head go through one transposing
// butterfly (9 shuffles, not 8 x 5) that leaves key (lane >> 2) & 7's score
// in each lane. At the end the warps merge their (max, sum, acc) in warp
// order. With one split (B x Hkv x chunks already fills the card) the
// block normalizes and writes o. With several it writes its fp32 partial
// (acc[D], m, l) per query head, a split with no keys m = -inf and l = 0,
// and a second kernel (one block per (query head, row)) merges the splits
// in split order: two launches a call, one partial buffer of (B, Hq,
// splits, D + 2) fp32 from the caller. Both merges run in a fixed order,
// so the result repeats bit for bit. Pages at or past seq_len and table
// entries < 0 are never read; a row with seq_len == 0 writes zeros. Page,
// token and head strides come from the caller, so HND and NHD share the
// kernel; AABB maps query head h to kv head h / group, ABAB to h % Hkv.
// int8 pages (kernel C', the C8 cache; replaces the scale folding of
// backends/pallas/operators/attention.py:225-268): K/V elements are int8
// and two (Hkv, D) fp32 scale rows come in. The key scale multiplies the
// staged fp32 query, s = sum_d (q[d] * scale * ks[kvh, d]) * k[d], and the
// value scale the normalized output, o[d] = vs[kvh, d] * sum_j p_j v_j[d]
// (after the split merge): both are linear, so this equals dequantizing K
// and V, up to summation order, with no bf16 rounding of a folded query
// and no extra pass. A row is D int8 values (128 bytes at D = 128), half
// the bytes of bf16. The scale row is the kv head's own, so ABAB needs no
// expanded copy.
// Windows (the TPU kernel's local_window/global_window, :54-90): with a
// local window the row keeps key positions [max(sl - 1 - local, 0), sl),
// plus [0, global) when a global window is set; with only a global window,
// [0, min(global, sl)). The splits divide a virtual index over the kept
// keys, [0, g_hi) then [b_lo, sl), so pages outside the window are never
// read: cost follows the window, not the context. -1 means no window.
// Any group: query heads go in chunks of 16, the last one partial (a
// group of 20 runs 16 + 4), as the TPU kernel pads its group to
// max(8, group) (:297).
// Any head_dim hd that is a multiple of 16 up to 256 runs at the next
// instantiated width D (64, 128, 256): the staged query and K/V rows are
// zero past hd (the ring's copies of those chunks zero-fill and read
// nothing), so they add nothing to q . k or p v, and columns past hd are
// never stored; rows in device memory are hd wide.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecKeys = 8;                        // keys per warp step; the butterfly below assumes 8
constexpr int kDecStep = kDecWarps * kDecKeys;     // keys per block step: the split ranges' unit
constexpr int kDecChunk = 16;                      // query heads of one block for groups > 4
constexpr int kDecMaxSplits = 1024;                // splits the merge takes (shape-sized: ~2 an SM)
constexpr unsigned kFull = 0xffffffffu;

// s[k] holds this lane's partial score of key k. Returns the full score
// of key (lane >> 2) & 7: each of the first three steps sends half of
// the remaining keys to the partner lane, the last two sum the slices.
__device__ __forceinline__ float transpose_sum8(const float (&s)[kDecKeys], int lane) {
  const bool up16 = lane & 16;
  float a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up16 ? s[i] : s[i + 4];
    a[i] = (up16 ? s[i + 4] : s[i]) + __shfl_xor_sync(kFull, send, 16);
  }
  const bool up8 = lane & 8;
  float b[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up8 ? a[i] : a[i + 2];
    b[i] = (up8 ? a[i + 2] : a[i]) + __shfl_xor_sync(kFull, send, 8);
  }
  const bool up4 = lane & 4;
  float c = (up4 ? b[1] : b[0]) + __shfl_xor_sync(kFull, up4 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(kFull, c, 2);
  return c + __shfl_xor_sync(kFull, c, 1);
}

// max / sum over the 8 keys, each held by lanes that differ in bits 2-4
__device__ __forceinline__ float keys_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 16));
}

__device__ __forceinline__ float keys_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

__device__ __forceinline__ int query_head(int g, int kvh, int group, int hkv, int abab) {
  return abab ? g * hkv + kvh : kvh * group + g;
}

// One warp's ring of staged K/V rows in shared memory: a stage holds the
// 8 K rows, then the 8 V rows, of one warp step; rows of up to 256 bytes
// get two stages, longer ones one (the registers hold the step in use, so
// one stage still overlaps the next step's loads with this step's math)
template <typename TC, int D>
struct WarpRing {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TC));
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kStages = kRowBytes <= 256 ? 2 : 1;
  static constexpr int kStageBytes = 2 * kDecKeys * kRowBytes;
  static constexpr int kBytes = kStages * kStageBytes;
  static_assert(kDecKeys * kRowChunks % 32 == 0, "each lane copies whole 16-byte chunks");
};

// the dynamic shared memory of a block: the staged queries (G x D fp32), then each warp's ring
template <typename TC, int D, int G>
constexpr int decode_smem_bytes() {
  return G * D * 4 + kDecWarps * WarpRing<TC, D>::kBytes;
}

// T: query/output type; TC: cache element type (T, or int8_t with scales);
// G: query heads of one block (a chunk of the group). With splits > 1 the
// block writes part[b][h][split] = (acc[D], m, l) instead of o.
template <typename T, typename TC, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ seq_lens, const int* __restrict__ block_tables,
                    T* __restrict__ out, float* __restrict__ part, int hq, int hkv, int hd, int block_size,
                    int max_blocks, int page_stride, int tok_stride, int head_stride, int splits, float scale,
                    int abab, int local_window, int global_window) {
  constexpr int E = D / 32;  // head_dim elements per lane
  constexpr bool kInt8 = std::is_same_v<TC, int8_t>;
  using Ring = WarpRing<TC, D>;

  extern __shared__ __align__(16) unsigned char decode_smem[];
  // scaled queries, reused for the warps' merged output; then the warps' K/V rings
  float(*q_s)[D] = reinterpret_cast<float(*)[D]>(decode_smem);
  __shared__ float m_w[kDecWarps][G], l_w[kDecWarps][G];

  const int group = hq / hkv;
  const int chunks = (group + G - 1) / G;
  const int kvh = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * G;
  const int gn = min(G, group - g0);  // heads of this chunk
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int seq_len = seq_lens[b];
  // kept keys: positions [0, g_hi), then [b_lo, seq_len)
  int g_hi = 0, b_lo = 0;
  if (local_window >= 0 || global_window >= 0) {
    g_hi = global_window >= 0 ? min(global_window, seq_len) : 0;
    const int lo = local_window >= 0 ? max(seq_len - 1 - local_window, 0) : seq_len;
    b_lo = max(lo, g_hi);
  }
  const int n_keys = g_hi + max(seq_len - b_lo, 0);
  // this split's range of the kept keys, in whole block steps
  const int span = ((n_keys + splits - 1) / splits + kDecStep - 1) / kDecStep * kDecStep;
  const int lo = split * span;
  const int hi = min(n_keys, lo + span);
  const int64_t part_row = static_cast<int64_t>(b) * hq;

  if (lo >= hi) {  // no keys: o = 0 (one split), or an empty partial
    for (int i = tid; i < gn * D; i += kDecThreads) {
      const int h = query_head(g0 + i / D, kvh, group, hkv, abab);
      if (splits == 1) {
        if (i % D < hd) out[(part_row + h) * hd + i % D] = mojo_from_float<T>(0.f);
      } else if (i % D == 0) {
        float* p = part + ((part_row + h) * splits + split) * (D + 2);
        p[D] = -INFINITY;
        p[D + 1] = 0.f;
      }
    }
    return;
  }

  for (int i = tid; i < gn * D; i += kDecThreads) {
    const int g = i / D;
    const int h = query_head(g0 + g, kvh, group, hkv, abab);
    const int d = i % D;
    float qv = 0.f;  // columns past hd: zero
    if (d < hd) {
      qv = mojo_to_float(q[(part_row + h) * hd + d]) * scale;
      if constexpr (kInt8) qv *= k_scale[kvh * hd + d];
    }
    q_s[g][d] = qv;
  }
  __syncthreads();

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t head_off = static_cast<int64_t>(kvh) * head_stride;
  const int key = (lane >> 2) & 7;  // the key whose full score this lane holds
  unsigned char* ring = decode_smem + G * D * 4 + warp * Ring::kBytes;

  // Lane k < 8 loads the table entry of key j0 + k: -1 where no row is
  // read (keys at or past the range, pages past the table, entries < 0).
  // The walk loads a step's entries one step before it copies its rows,
  // so that no copy waits on a table load.
  auto lookup = [&](int j0) {
    const int j = j0 + lane;
    const int lb = (j < g_hi ? j : j - g_hi + b_lo) / block_size;
    return lane < kDecKeys && j < hi && lb < max_blocks ? table[lb] : -1;
  };
  // Copy the K and V rows of keys [j0, j0 + 8), whose table entries lane k
  // holds in `page`, into ring stage `st` (each lane its share of 16-byte
  // chunks; keys without a row are zero-filled and never read), one
  // cp.async group; returns the mask of the keys that hold a row.
  auto stage_rows = [&](int j0, int page, int st) {
    const unsigned mask = __ballot_sync(kFull, page >= 0) & ((1u << kDecKeys) - 1);
    unsigned char* dst = ring + st * Ring::kStageBytes;
#pragma unroll
    for (int i = 0; i < kDecKeys * Ring::kRowChunks / 32; ++i) {
      const int c = lane + 32 * i, k = c / Ring::kRowChunks;
      const int row_page = __shfl_sync(kFull, page, k);
      const int j = j0 + k;
      const int pos = j < g_hi ? j : j - g_hi + b_lo;
      const int col = (c % Ring::kRowChunks) * (16 / static_cast<int>(sizeof(TC)));
      const bool keep = row_page >= 0 && col < hd;  // chunks past hd zero-fill
      const int64_t at = keep ? static_cast<int64_t>(row_page) * page_stride +
                                    static_cast<int64_t>(pos % block_size) * tok_stride + head_off + col
                              : 0;
      cp_async16(dst + c * 16, kc + at, keep);
      cp_async16(dst + kDecKeys * Ring::kRowBytes + c * 16, vc + at, keep);
    }
    cp_async_commit();
    return mask;
  };

  // the warp's steps: keys lo + 8 warp + 64 i; stage i % kStages, copied kStages steps ahead
  const int first = lo + warp * kDecKeys;
  unsigned masks = 0;  // 8 bits a stage in flight
#pragma unroll
  for (int st = 0; st < Ring::kStages; ++st) {
    masks |= stage_rows(first + st * kDecStep, lookup(first + st * kDecStep), st) << (8 * st);
  }
  int page = lookup(first + Ring::kStages * kDecStep);  // the first refill's table entries
  int st = 0;
  for (int j0 = first; j0 < hi; j0 += kDecStep) {
    cp_async_wait<Ring::kStages - 1>();
    __syncwarp();  // every lane's copies of this step have landed
    float kf[kDecKeys][E], vf[kDecKeys][E];
    const unsigned char* src = ring + st * Ring::kStageBytes;
#pragma unroll
    for (int k = 0; k < kDecKeys; ++k) {
      mojo_load_row<TC, E>(reinterpret_cast<const TC*>(src + k * Ring::kRowBytes) + lane * E, kf[k]);
      mojo_load_row<TC, E>(reinterpret_cast<const TC*>(src + (kDecKeys + k) * Ring::kRowBytes) + lane * E, vf[k]);
    }
    const unsigned valid = (masks >> (8 * st)) & 0xffu;
    __syncwarp();  // every lane has read the stage: refill it
    const unsigned mask = stage_rows(j0 + Ring::kStages * kDecStep, page, st);
    masks = (masks & ~(0xffu << (8 * st))) | (mask << (8 * st));
    st = st + 1 == Ring::kStages ? 0 : st + 1;
    page = lookup(j0 + (Ring::kStages + 1) * kDecStep);  // in flight during this step's math

#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= gn) break;
      float qf[E], s[kDecKeys];
#pragma unroll
      for (int e = 0; e < E; ++e) qf[e] = q_s[g][lane * E + e];
#pragma unroll
      for (int k = 0; k < kDecKeys; ++k) {
        s[k] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s[k] += qf[e] * kf[k][e];
      }
      float score = transpose_sum8(s, lane);
      score = (valid >> key) & 1 ? score : -INFINITY;

      const float m_new = fmaxf(m[g], keys_max(score));
      const float p = m_new == -INFINITY || score == -INFINITY ? 0.f : expf(score - m_new);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[g] - m_new);
      l[g] = l[g] * alpha + keys_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int k = 0; k < kDecKeys; ++k) {
        const float pk = __shfl_sync(kFull, p, 4 * k);  // lane 4k holds key k
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += pk * vf[k][e];
      }
    }
  }
  cp_async_wait<0>();

  // merge the warps: the block's max per head, then each warp's share in turn
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_w[warp][g] = m[g];
      l_w[warp][g] = l[g];
    }
  }
  __syncthreads();  // also: every warp is done reading q_s
  float own[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    own[g] = m[g] == -INFINITY ? 0.f : expf(m[g] - mx);
  }
  for (int w = 0; w < kDecWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= gn) break;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float share = acc[g][e] * own[g];
          q_s[g][lane * E + e] = w == 0 ? share : q_s[g][lane * E + e] + share;
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < gn * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY, sum = 0.f;
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    for (int w = 0; w < kDecWarps; ++w) sum += m_w[w][g] == -INFINITY ? 0.f : l_w[w][g] * expf(m_w[w][g] - mx);
    const int h = query_head(g0 + g, kvh, group, hkv, abab);
    if (splits == 1) {
      if (d >= hd) continue;
      float o = sum > 0.f ? q_s[g][d] / sum : 0.f;
      if constexpr (kInt8) o *= v_scale[kvh * hd + d];
      out[(part_row + h) * hd + d] = mojo_from_float<T>(o);
    } else {
      float* p = part + ((part_row + h) * splits + split) * (D + 2);
      p[d] = q_s[g][d];
      if (d == 0) {
        p[D] = mx;
        p[D + 1] = sum;
      }
    }
  }
}

// o[b][h] from the splits' partials, in split order; a partial with
// m = -inf holds no keys and is skipped (its acc is never written). One
// block of D threads per (query head, row): the splits' (m, l) are loaded
// together into shared memory, their weights exp(m - max) computed once,
// then each thread adds its column over the splits in order, the loads of
// all splits in flight.
template <typename T, int D>
__global__ void __launch_bounds__(D)
paged_decode_merge_kernel(const float* __restrict__ part, const float* __restrict__ v_scale, T* __restrict__ out,
                          int hq, int hkv, int hd, int splits, int abab) {
  __shared__ float w_s[kDecMaxSplits], l_s[kDecMaxSplits];
  __shared__ float warp_max[D / 32];
  __shared__ float total;
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int64_t row = static_cast<int64_t>(b) * hq + h;
  const float* p = part + row * splits * (D + 2);
  float mx = -INFINITY;
  for (int s = d; s < splits; s += D) {
    const float m = p[s * (D + 2) + D];
    w_s[s] = m;
    l_s[s] = p[s * (D + 2) + D + 1];
    mx = fmaxf(mx, m);
  }
  mx = mojo_warp_max(mx);
  if (d % 32 == 0) warp_max[d / 32] = mx;
  __syncthreads();
  mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < D / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  for (int s = d; s < splits; s += D) w_s[s] = w_s[s] == -INFINITY ? 0.f : expf(w_s[s] - mx);
  __syncthreads();
  if (d == 0) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += w_s[s] == 0.f ? 0.f : l_s[s] * w_s[s];
    total = sum;
  }
  float acc = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float wgt = w_s[s];
    const float v = p[s * (D + 2) + d];
    acc += wgt == 0.f ? 0.f : v * wgt;
  }
  __syncthreads();
  if (d >= hd) return;
  float o = total > 0.f ? acc / total : 0.f;
  if (v_scale != nullptr) {
    const int kvh = abab ? h % hkv : h / (hq / hkv);
    o *= v_scale[kvh * hd + d];
  }
  out[row * hd + d] = mojo_from_float<T>(o);
}

struct DecodeArgs {
  const float* ks;
  const float* vs;
  const int* sl;
  const int* bt;
  float* part;
  int B, hq, hkv, hd, block_size, max_blocks, page_stride, tok_stride, head_stride, splits;
  float scale;
  int abab, local_window, global_window;
};

template <typename T, typename TC, int D, int G>
int launch_walk(const DecodeArgs& a, const T* q, const TC* kc, const TC* vc, T* out, cudaStream_t s) {
  constexpr int smem = decode_smem_bytes<TC, D, G>();
  static const cudaError_t attr = cudaFuncSetAttribute(paged_decode_kernel<T, TC, D, G>,
                                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int chunks = (a.hq / a.hkv + G - 1) / G;
  const dim3 grid(a.hkv * chunks, a.B, a.splits);
  paged_decode_kernel<T, TC, D, G><<<grid, kDecThreads, smem, s>>>(
      q, kc, vc, a.ks, a.vs, a.sl, a.bt, out, a.part, a.hq, a.hkv, a.hd, a.block_size, a.max_blocks, a.page_stride,
      a.tok_stride, a.head_stride, a.splits, a.scale, a.abab, a.local_window, a.global_window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TC, int D>
int launch_decode(const DecodeArgs& a, const void* q, const void* kc, const void* vc, void* out, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(kc);
  const TC* vt = static_cast<const TC*>(vc);
  T* ot = static_cast<T*>(out);
  const int rc = a.hq / a.hkv <= 4 ? launch_walk<T, TC, D, 4>(a, qt, kt, vt, ot, s)
                                   : launch_walk<T, TC, D, kDecChunk>(a, qt, kt, vt, ot, s);
  if (rc != 0) return rc;
  if (a.splits > 1) {
    paged_decode_merge_kernel<T, D><<<dim3(a.hq, a.B), D, 0, s>>>(
        a.part, std::is_same_v<TC, int8_t> ? a.vs : nullptr, ot, a.hq, a.hkv, a.hd, a.splits, a.abab);
  }
  return static_cast<int>(cudaGetLastError());
}

// the instantiated width that holds hd (a multiple of 16 up to 256)
template <typename T, typename TC>
int dispatch_head_dim(const DecodeArgs& a, const void* q, const void* kc, const void* vc, void* out,
                      cudaStream_t s) {
  if (a.hd <= 0 || a.hd % 16 != 0 || a.hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (a.hd <= 64) return launch_decode<T, TC, 64>(a, q, kc, vc, out, s);
  if (a.hd <= 128) return launch_decode<T, TC, 128>(a, q, kc, vc, out, s);
  return launch_decode<T, TC, 256>(a, q, kc, vc, out, s);
}

}  // namespace

// q/out (B, hq, D) contiguous; caches addressed as
// page * page_stride + token * tok_stride + kv_head * head_stride + d, in
// q's dtype, or int8 when kv_int8 with k_scale/v_scale (hkv, D) fp32;
// seq_lens (B,) and block_tables (B, max_blocks) int32. D a multiple of
// 16 up to 256, run at the next of 64, 128, 256 (Dp); any hq a multiple of
// hkv. 1 <= splits <= 1024 (module note); with splits > 1, partial holds
// B * hq * splits * (Dp + 2) fp32 of scratch.
// local_window / global_window >= 0 set a window, -1 none.
extern "C" int mojo_paged_decode(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* seq_lens, const void* block_tables, void* out,
                                 void* partial, int B, int hq, int hkv, int D, int block_size, int max_blocks,
                                 int page_stride, int tok_stride, int head_stride, int splits, float scale, int abab,
                                 int local_window, int global_window, int kv_int8, int dtype, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0 || splits < 1 || splits > kDecMaxSplits || (splits > 1 && partial == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
                     static_cast<const int*>(seq_lens), static_cast<const int*>(block_tables),
                     static_cast<float*>(partial), B, hq, hkv, D, block_size, max_blocks, page_stride, tok_stride,
                     head_stride, splits, scale, abab, local_window, global_window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = kv_int8 ? dispatch_head_dim<T, int8_t>(a, q, k_cache, v_cache, out, s)
                 : dispatch_head_dim<T, T>(a, q, k_cache, v_cache, out, s);
  });
  return rc;
}
