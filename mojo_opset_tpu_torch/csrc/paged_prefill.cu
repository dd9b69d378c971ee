// Kernel D: varlen causal prefill GQA over the paged KV cache.
//
// Replaces the JAX package's backends/pallas/kernels/flash_prefill.py:358
// (paged_prefill_gqa, bodies _prefill_kernel :35 for HND and
// _prefill_kernel_nhd :197 for NHD).
//
// Query row i of sequence b sits at absolute position
// kv_len[b] - q_len[b] + i and sees keys at positions <= it, so chunked
// prefill with context already in the cache is covered.
//
// Bound on the H100: FLOPs (4 * D per visible query-key pair; K/V tiles
// are re-read once per query tile). Design: one block per (query tile,
// kv head, sequence). The tile holds 64 rows = (64 / group) tokens times
// the group's query heads, so each K/V tile serves every head of the
// group. A block walks 32-key tiles up to its causal bound, staging K and
// V in shared memory as fp32, and keeps an fp32 online softmax: each
// thread owns 4 rows x (32/8) score columns and 4 rows x (D/8) output
// columns in registers. Both products are scalar FMAs (tensor-core MMA is
// later work). Partial tiles, missing tokens and keys past the causal
// bound are masked: blocks run in no order, so unlike the TPU kernel's
// clamped last tile (:80-83) no tile overlaps another. Table entries < 0
// are never read.
//
// int8 pages (kernel D', the C8 cache; replaces the scale folding of
// backends/pallas/operators/attention.py:271-318): K/V are int8 with two
// (Hkv, D) fp32 scale rows. The key scale multiplies the staged fp32
// query and the value scale the normalized output, both linear, so this
// equals dequantizing K and V up to summation order. K/V tiles are staged
// with 16-byte loads (16 int8 values, 8 bf16): lane j of a warp takes key
// j of the tile, so the stores into the padded shared rows hit 32 banks.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kPreThreads = 128;
constexpr int kPreRows = 64;               // (token, head) rows per block
constexpr int kPreTR = 4;                  // rows per thread
constexpr int kPreCG = 8;                  // threads sharing a row group
constexpr int kPreBK = 32;                 // keys per tile
constexpr int kPreTC = kPreBK / kPreCG;    // score columns per thread
constexpr int kPreSS = kPreBK + 1;         // padded row stride of P

static_assert(kPreRows == kPreTR * kPreThreads / kPreCG, "thread tiling must cover the rows");

template <int D>
constexpr int prefill_smem_floats() {
  return kPreRows * (D + 1) + 2 * kPreBK * (D + 1) + kPreRows * kPreSS;
}

// T: query/output type; TC: cache element type (T, or int8_t with scales)
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kPreThreads)
paged_prefill_kernel(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
                     const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                     const int* __restrict__ cu_q, const int* __restrict__ cu_kv,
                     const int* __restrict__ block_tables, T* __restrict__ out, int hq, int hkv,
                     int block_size, int max_blocks, int page_stride, int tok_stride, int head_stride,
                     float scale, int abab) {
  constexpr int QS = D + 1;       // padded row stride of Q, K, V (bank spread)
  constexpr int DC = D / kPreCG;  // output columns per thread
  constexpr bool kInt8 = std::is_same_v<TC, int8_t>;
  constexpr int VE = 16 / static_cast<int>(sizeof(TC));  // cache elements per 16-byte load
  static_assert(kPreBK == 32, "staging maps the tile's keys onto the 32 lanes");

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tokens_per_tile = kPreRows / group;
  const int q_start = cu_q[b];
  const int q_len = cu_q[b + 1] - q_start;
  const int kv_len = cu_kv != nullptr ? cu_kv[b + 1] - cu_kv[b] : q_len;
  const int tok0 = tile * tokens_per_tile;  // first token of the tile, within the sequence
  if (tok0 >= q_len) return;                // block-uniform
  const int n_rows = min(tokens_per_tile, q_len - tok0) * group;
  const int abs0 = kv_len - q_len + tok0;   // absolute position of the tile's first token
  const int kv_end = min(kv_len, abs0 + n_rows / group);  // keys any row of the tile sees

  extern __shared__ float mojo_smem[];
  float* q_s = mojo_smem;
  float* k_s = q_s + kPreRows * QS;
  float* v_s = k_s + kPreBK * QS;
  float* p_s = v_s + kPreBK * QS;
  __shared__ int64_t off_s[kPreBK];

  const int tid = threadIdx.x;
  const int rg = tid / kPreCG;  // row group: rows rg*4 .. rg*4+3
  const int cg = tid % kPreCG;  // column group: score cols cg + 8c, output cols cg + 8c

  for (int i = tid; i < kPreRows * D; i += kPreThreads) {
    const int r = i / D;
    const int d = i % D;
    float val = 0.f;
    if (r < n_rows) {
      const int g = r % group;
      const int h = abab ? g * hkv + kvh : kvh * group + g;
      val = mojo_to_float(q[(static_cast<int64_t>(q_start + tok0 + r / group) * hq + h) * D + d]) * scale;
      if constexpr (kInt8) val *= k_scale[kvh * D + d];
    }
    q_s[r * QS + d] = val;
  }

  float m[kPreTR], l[kPreTR], acc[kPreTR][DC];
  int row_abs[kPreTR];
#pragma unroll
  for (int i = 0; i < kPreTR; ++i) {
    const int r = rg * kPreTR + i;
    m[i] = -INFINITY;
    l[i] = 0.f;
    row_abs[i] = r < n_rows ? abs0 + r / group : -1;  // -1: no key is visible
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int* table = block_tables + static_cast<int64_t>(b) * max_blocks;
  const int64_t head_off = static_cast<int64_t>(kvh) * head_stride;

  for (int j0 = 0; j0 < kv_end; j0 += kPreBK) {
    __syncthreads();  // previous tile fully consumed (and Q staged on the first pass)
    if (tid < kPreBK) {
      const int pos = j0 + tid;
      const int lb = pos / block_size;
      const int page = pos < kv_end && lb < max_blocks ? table[lb] : -1;
      off_s[tid] = page < 0 ? -1
                            : static_cast<int64_t>(page) * page_stride +
                                  static_cast<int64_t>(pos % block_size) * tok_stride + head_off;
    }
    __syncthreads();
    for (int i = tid; i < kPreBK * (D / VE); i += kPreThreads) {
      const int j = i % kPreBK;  // key: lane j of each warp
      const int d0 = (i / kPreBK) * VE;
      const int64_t off = off_s[j];
      float kf[VE], vf[VE];
      if (off >= 0) {
        mojo_load_row<TC, VE>(kc + off + d0, kf);
        mojo_load_row<TC, VE>(vc + off + d0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        k_s[j * QS + d0 + e] = kf[e];
        v_s[j * QS + d0 + e] = vf[e];
      }
    }
    __syncthreads();

    // S = Q K^T on this thread's 4 x kPreTC cells
    float s[kPreTR][kPreTC];
#pragma unroll
    for (int i = 0; i < kPreTR; ++i)
#pragma unroll
      for (int c = 0; c < kPreTC; ++c) s[i][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kPreTR], kv[kPreTC];
#pragma unroll
      for (int i = 0; i < kPreTR; ++i) qv[i] = q_s[(rg * kPreTR + i) * QS + d];
#pragma unroll
      for (int c = 0; c < kPreTC; ++c) kv[c] = k_s[(cg + kPreCG * c) * QS + d];
#pragma unroll
      for (int i = 0; i < kPreTR; ++i)
#pragma unroll
        for (int c = 0; c < kPreTC; ++c) s[i][c] += qv[i] * kv[c];
    }

    // mask, online softmax; the 8 threads of a row group are 8 adjacent lanes
#pragma unroll
    for (int i = 0; i < kPreTR; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kPreTC; ++c) {
        const int j = cg + kPreCG * c;
        const bool keep = j0 + j <= row_abs[i] && off_s[j] >= 0;
        s[i][c] = keep ? s[i][c] : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int o = 1; o < kPreCG; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kPreTC; ++c) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][c] - m_new);
        p_s[(rg * kPreTR + i) * kPreSS + cg + kPreCG * c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < kPreCG; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
    for (int j = 0; j < kPreBK; ++j) {
      float pv[kPreTR];
#pragma unroll
      for (int i = 0; i < kPreTR; ++i) pv[i] = p_s[(rg * kPreTR + i) * kPreSS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float v = v_s[j * QS + cg + kPreCG * c];
#pragma unroll
        for (int i = 0; i < kPreTR; ++i) acc[i][c] += pv[i] * v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPreTR; ++i) {
    const int r = rg * kPreTR + i;
    if (r < n_rows) {
      const int g = r % group;
      const int h = abab ? g * hkv + kvh : kvh * group + g;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      T* o = out + (static_cast<int64_t>(q_start + tok0 + r / group) * hq + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float val = acc[i][c] * inv;
        if constexpr (kInt8) val *= v_scale[kvh * D + cg + kPreCG * c];
        o[cg + kPreCG * c] = mojo_from_float<T>(val);
      }
    }
  }
}

template <typename T, typename TC, int D>
int launch_prefill(const T* q, const TC* kc, const TC* vc, const float* ks, const float* vs, const int* cu_q,
                   const int* cu_kv, const int* bt, T* out, int B, int max_q_len, int hq, int hkv, int block_size,
                   int max_blocks, int page_stride, int tok_stride, int head_stride, float scale, int abab,
                   cudaStream_t stream) {
  constexpr size_t smem = prefill_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_kernel<T, TC, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tokens_per_tile = kPreRows / (hq / hkv);
  const dim3 grid((max_q_len + tokens_per_tile - 1) / tokens_per_tile, hkv, B);
  paged_prefill_kernel<T, TC, D><<<grid, kPreThreads, smem, stream>>>(q, kc, vc, ks, vs, cu_q, cu_kv, bt, out, hq,
                                                                       hkv, block_size, max_blocks, page_stride,
                                                                       tok_stride, head_stride, scale, abab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TC>
int dispatch_head_dim(const void* q, const void* kc, const void* vc, const float* ks, const float* vs,
                      const int* cu_q, const int* cu_kv, const int* bt, void* out, int B, int max_q_len, int hq,
                      int hkv, int D, int block_size, int max_blocks, int page_stride, int tok_stride,
                      int head_stride, float scale, int abab, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const TC* kt = static_cast<const TC*>(kc);
  const TC* vt = static_cast<const TC*>(vc);
  T* ot = static_cast<T*>(out);
  if (D == 64) {
    return launch_prefill<T, TC, 64>(qt, kt, vt, ks, vs, cu_q, cu_kv, bt, ot, B, max_q_len, hq, hkv, block_size,
                                     max_blocks, page_stride, tok_stride, head_stride, scale, abab, s);
  }
  if (D == 128) {
    return launch_prefill<T, TC, 128>(qt, kt, vt, ks, vs, cu_q, cu_kv, bt, ot, B, max_q_len, hq, hkv, block_size,
                                      max_blocks, page_stride, tok_stride, head_stride, scale, abab, s);
  }
  if (D == 256) {
    return launch_prefill<T, TC, 256>(qt, kt, vt, ks, vs, cu_q, cu_kv, bt, ot, B, max_q_len, hq, hkv, block_size,
                                      max_blocks, page_stride, tok_stride, head_stride, scale, abab, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/out (T, hq, D) contiguous; cu_q (B+1,) int32; cu_kv (B+1,) int32 or
// null (kv_len = q_len); caches addressed as
// page * page_stride + token * tok_stride + kv_head * head_stride + d, in
// q's dtype, or int8 when kv_int8 with k_scale/v_scale (hkv, D) fp32;
// block_tables (B, max_blocks) int32. max_q_len bounds the grid. D in
// {64, 128, 256}; hq / hkv <= 64.
extern "C" int mojo_paged_prefill(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                                  const void* v_scale, const void* cu_q, const void* cu_kv,
                                  const void* block_tables, void* out, int B, int max_q_len, int hq, int hkv, int D,
                                  int block_size, int max_blocks, int page_stride, int tok_stride, int head_stride,
                                  float scale, int abab, int kv_int8, int dtype, void* stream) {
  if (B <= 0 || max_q_len <= 0) return static_cast<int>(cudaSuccess);
  if (hq % hkv != 0 || hq / hkv > kPreRows) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* cq = static_cast<const int*>(cu_q);
  const int* ck = static_cast<const int*>(cu_kv);
  const int* bt = static_cast<const int*>(block_tables);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = kv_int8 ? dispatch_head_dim<T, int8_t>(q, k_cache, v_cache, ks, vs, cq, ck, bt, out, B, max_q_len, hq, hkv,
                                                 D, block_size, max_blocks, page_stride, tok_stride, head_stride,
                                                 scale, abab, s)
                 : dispatch_head_dim<T, T>(q, k_cache, v_cache, ks, vs, cq, ck, bt, out, B, max_q_len, hq, hkv, D,
                                           block_size, max_blocks, page_stride, tok_stride, head_stride, scale, abab,
                                           s);
  });
  return rc;
}
