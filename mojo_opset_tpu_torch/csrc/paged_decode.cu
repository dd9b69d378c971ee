// Kernel C: one-token GQA decode over a paged KV cache.
//
// Replaces the JAX package's backends/pallas/kernels/paged_decode.py:260
// (paged_decode_gqa, body _decode_kernel :30).
//
// Bound on the H100: the bytes of K and V. Every cached row is read once
// per step and takes 4 * group FLOPs per element.
// Design: one block per (kv head, batch row) serves all `group` query
// heads of that kv head from each K/V row it loads (4 at Qwen3-4B), so
// K/V cross device memory once per step. The block's 8 warps walk the
// context independently, 8 keys at a time (warp w takes keys 64i + 8w ..
// 64i + 8w + 7): lanes split head_dim, each lane issues its slice of the
// 8 K rows and 8 V rows before it uses any, and the warp keeps its own
// fp32 online softmax per head, as the TPU kernel does per block
// (:212-240). No barrier stands inside the walk. The 8 partial scores of
// one head go through one transposing butterfly (9 shuffles, not 8 x 5)
// that leaves key (lane >> 2) & 7's score in each lane. At the end the
// warps merge their (max, sum, acc) in a fixed order, so the result does
// not depend on scheduling. Pages at or past seq_len and table entries < 0
// are never read; a row with seq_len == 0 writes zeros. Page, token and
// head strides come from the caller, so HND and NHD share the kernel; AABB
// maps query head h to kv head h / group, ABAB to h % Hkv.
// int8 pages (kernel C', the C8 cache; replaces the scale folding of
// backends/pallas/operators/attention.py:225-268): K/V elements are int8
// and two (Hkv, D) fp32 scale rows come in. The key scale multiplies the
// staged fp32 query, s = sum_d (q[d] * scale * ks[kvh, d]) * k[d], and the
// value scale the normalized output, o[d] = vs[kvh, d] * sum_j p_j v_j[d]:
// both are linear, so this equals dequantizing K and V, up to summation
// order, with no bf16 rounding of a folded query and no extra launch. A
// lane loads D / 32 int8 values of a row (4 bytes at D = 128), half the
// bytes of bf16. The scale row is the kv head's own, so ABAB needs no
// expanded copy.
// Windows (the TPU kernel's local_window/global_window, :54-90): with a
// local window the row keeps key positions [max(sl - 1 - local, 0), sl),
// plus [0, global) when a global window is set; with only a global window,
// [0, min(global, sl)). The warps walk a virtual index over the kept keys,
// [0, g_hi) then [b_lo, sl), so pages outside the window are never read:
// cost follows the window, not the context. -1 means no window.
// Known limit: B * Hkv blocks (64 at the main path's batch of 8) leave
// most of the 132 SMs idle; a split-KV pass is the fix.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecKeys = 8;  // keys per warp step; the butterfly below assumes 8
constexpr int kDecMaxGroup = 16;
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

// T: query/output type; TC: cache element type (T, or int8_t with scales);
// G: compile-time bound on the group (query heads per kv head)
template <typename T, typename TC, int D, int G>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
                    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                    const int* __restrict__ seq_lens, const int* __restrict__ block_tables,
                    T* __restrict__ out, int hq, int hkv, int block_size, int max_blocks,
                    int page_stride, int tok_stride, int head_stride, float scale, int abab,
                    int local_window, int global_window) {
  constexpr int E = D / 32;  // head_dim elements per lane
  constexpr bool kInt8 = std::is_same_v<TC, int8_t>;

  __shared__ float q_s[G][D];  // scaled queries; reused for the warps' merged output
  __shared__ float m_w[kDecWarps][G], l_w[kDecWarps][G];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  for (int i = tid; i < group * D; i += kDecThreads) {
    const int g = i / D;
    const int h = abab ? g * hkv + kvh : kvh * group + g;
    float qv = mojo_to_float(q[(static_cast<int64_t>(b) * hq + h) * D + i % D]) * scale;
    if constexpr (kInt8) qv *= k_scale[kvh * D + i % D];
    q_s[g][i % D] = qv;
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

  const int seq_len = seq_lens[b];
  // kept keys: positions [0, g_hi), then [b_lo, seq_len)
  int g_hi = 0, b_lo = 0;
  if (local_window >= 0 || global_window >= 0) {
    g_hi = global_window >= 0 ? min(global_window, seq_len) : 0;
    const int lo = local_window >= 0 ? max(seq_len - 1 - local_window, 0) : seq_len;
    b_lo = max(lo, g_hi);
  }
  const int n_keys = g_hi + max(seq_len - b_lo, 0);
  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t lane_off = static_cast<int64_t>(kvh) * head_stride + lane * E;
  const int key = (lane >> 2) & 7;  // the key whose full score this lane holds

  for (int j0 = warp * kDecKeys; j0 < n_keys; j0 += kDecWarps * kDecKeys) {
    float kf[kDecKeys][E], vf[kDecKeys][E];
    bool valid[kDecKeys];
#pragma unroll
    for (int k = 0; k < kDecKeys; ++k) {
      const int j = j0 + k;
      const int pos = j < g_hi ? j : j - g_hi + b_lo;
      const int lb = pos / block_size;
      const int page = j < n_keys && lb < max_blocks ? table[lb] : -1;
      valid[k] = page >= 0;  // warp-uniform
      if (valid[k]) {
        const int64_t at = static_cast<int64_t>(page) * page_stride +
                           static_cast<int64_t>(pos % block_size) * tok_stride + lane_off;
        mojo_load_row<TC, E>(kc + at, kf[k]);
        mojo_load_row<TC, E>(vc + at, vf[k]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[k][e] = vf[k][e] = 0.f;
      }
    }

#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= group) break;
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
#pragma unroll
      for (int k = 0; k < kDecKeys; ++k) score = (k == key && !valid[k]) ? -INFINITY : score;

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

  // merge the warps: global max per head, then each warp's share in turn
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
        if (g >= group) break;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float part = acc[g][e] * own[g];
          q_s[g][lane * E + e] = w == 0 ? part : q_s[g][lane * E + e] + part;
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < group * D; i += kDecThreads) {
    const int g = i / D;
    float mx = -INFINITY, sum = 0.f;
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    for (int w = 0; w < kDecWarps; ++w) sum += m_w[w][g] == -INFINITY ? 0.f : l_w[w][g] * expf(m_w[w][g] - mx);
    const int h = abab ? g * hkv + kvh : kvh * group + g;
    float o = sum > 0.f ? q_s[g][i % D] / sum : 0.f;
    if constexpr (kInt8) o *= v_scale[kvh * D + i % D];
    out[(static_cast<int64_t>(b) * hq + h) * D + i % D] = mojo_from_float<T>(o);
  }
}

template <typename T, typename TC, int D>
void launch_decode(dim3 grid, cudaStream_t s, int group, const T* q, const TC* kc, const TC* vc, const float* ks,
                   const float* vs, const int* sl, const int* bt, T* out, int hq, int hkv, int block_size,
                   int max_blocks, int page_stride, int tok_stride, int head_stride, float scale, int abab,
                   int local_window, int global_window) {
  if (group <= 4) {
    paged_decode_kernel<T, TC, D, 4><<<grid, kDecThreads, 0, s>>>(q, kc, vc, ks, vs, sl, bt, out, hq, hkv,
                                                                   block_size, max_blocks, page_stride,
                                                                   tok_stride, head_stride, scale, abab,
                                                                   local_window, global_window);
  } else {
    paged_decode_kernel<T, TC, D, kDecMaxGroup><<<grid, kDecThreads, 0, s>>>(
        q, kc, vc, ks, vs, sl, bt, out, hq, hkv, block_size, max_blocks, page_stride, tok_stride, head_stride,
        scale, abab, local_window, global_window);
  }
}

template <typename T, typename TC>
int dispatch_head_dim(dim3 grid, cudaStream_t s, int group, const void* q, const void* kc, const void* vc,
                      const float* ks, const float* vs, const int* sl, const int* bt, void* out, int hq, int hkv,
                      int D, int block_size, int max_blocks, int page_stride, int tok_stride, int head_stride,
                      float scale, int abab, int local_window, int global_window) {
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(kc);
  const TC* vt = static_cast<const TC*>(vc);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 64:
      launch_decode<T, TC, 64>(grid, s, group, qt, kt, vt, ks, vs, sl, bt, ot, hq, hkv, block_size, max_blocks,
                               page_stride, tok_stride, head_stride, scale, abab, local_window, global_window);
      break;
    case 128:
      launch_decode<T, TC, 128>(grid, s, group, qt, kt, vt, ks, vs, sl, bt, ot, hq, hkv, block_size, max_blocks,
                                page_stride, tok_stride, head_stride, scale, abab, local_window, global_window);
      break;
    case 256:
      launch_decode<T, TC, 256>(grid, s, group, qt, kt, vt, ks, vs, sl, bt, ot, hq, hkv, block_size, max_blocks,
                                page_stride, tok_stride, head_stride, scale, abab, local_window, global_window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (B, hq, D) contiguous; caches addressed as
// page * page_stride + token * tok_stride + kv_head * head_stride + d, in
// q's dtype, or int8 when kv_int8 with k_scale/v_scale (hkv, D) fp32;
// seq_lens (B,) and block_tables (B, max_blocks) int32. D in {64, 128,
// 256}; hq / hkv <= 16; local_window / global_window >= 0 set a window, -1
// none (module note).
extern "C" int mojo_paged_decode(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                                 const void* v_scale, const void* seq_lens, const void* block_tables, void* out,
                                 int B, int hq, int hkv, int D, int block_size, int max_blocks, int page_stride,
                                 int tok_stride, int head_stride, float scale, int abab, int local_window,
                                 int global_window, int kv_int8, int dtype, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (hq % hkv != 0 || hq / hkv > kDecMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(hkv, B);
  const int group = hq / hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* sl = static_cast<const int*>(seq_lens);
  const int* bt = static_cast<const int*>(block_tables);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = kv_int8 ? dispatch_head_dim<T, int8_t>(grid, s, group, q, k_cache, v_cache, ks, vs, sl, bt, out, hq, hkv,
                                                 D, block_size, max_blocks, page_stride, tok_stride, head_stride,
                                                 scale, abab, local_window, global_window)
                 : dispatch_head_dim<T, T>(grid, s, group, q, k_cache, v_cache, ks, vs, sl, bt, out, hq, hkv, D,
                                           block_size, max_blocks, page_stride, tok_stride, head_stride, scale,
                                           abab, local_window, global_window);
  });
  return rc;
}
