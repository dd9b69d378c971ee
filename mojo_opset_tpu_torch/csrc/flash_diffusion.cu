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
// pair and query head; 6 * D in dq, 8 * D in dk/dv). This first version does
// them as fp32 scalar FMAs (tensor-core tiles are later work), so it runs at
// the FMA pipes' rate, not the tensor cores'.
//
// Design: kernel J's (csrc/flash_swa.cu) tiling, staging and products, shared
// through csrc/flash_tiles.cuh, with the mask in place of J's sequence and
// window arithmetic.
//   forward / dq: one block per (tile of 64 query rows, query head, batch).
//     For each tile of 32 keys the block first loads the (64 x 32) mask tile
//     into shared memory as bytes and skips the tile when it keeps nothing
//     (a block-diffusion mask's upper blocks, a padded batch row's pad
//     keys); otherwise it stages K and V as fp32 and each thread computes
//     4 rows x 4 score columns and 4 rows x D/8 output columns in registers.
//     The forward keeps an fp32 online softmax. dq computes delta =
//     rowsum(do * o) for its rows (and writes it for dk/dv), recomputes
//     p = exp(s - lse), ds = p * (dp - delta) on the kept pairs, and
//     dq = scale * ds K.
//   dk/dv: one block per (tile of KR keys, kv head, batch); it loops over
//     the query tiles and over the group's query heads, reading the mask
//     tile transposed by swapping its strides (no transposed copy, no
//     padded mask in HBM), skipping tiles that keep nothing, and
//     accumulating dk and dv in registers: they are written once, in the
//     input type, with no atomics and no per-query-head partials (the TPU
//     kernel's (B * hq, Sk, D) fp32 partials summed outside, :283-284). KR is
//     64 keys for D <= 128 and 32 for D = 256. Every sum runs in a fixed
//     order, so dq, dk and dv repeat bit for bit.
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

// -- launchers --------------------------------------------------------------------

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, float empty, const DiffArgs& a,
               cudaStream_t s) {
  constexpr size_t smem = rows_smem_floats<D>(kRows, 1, kBK, 2) * sizeof(float);
  if (int rc = set_smem(flash_diffusion_fwd_kernel<T, D>, smem)) return rc;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.hq, a.B);
  flash_diffusion_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), lse, empty,
      a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout, const float* lse,
              void* dq, float* delta, const DiffArgs& a, cudaStream_t s) {
  constexpr size_t smem = rows_smem_floats<D>(kRows, 2, kBK, 2) * sizeof(float);
  if (int rc = set_smem(flash_diffusion_dq_kernel<T, D>, smem)) return rc;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.hq, a.B);
  flash_diffusion_dq_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse, const float* delta,
               void* dk, void* dv, const DiffArgs& a, cudaStream_t s) {
  constexpr int KR = dkv_rows<D>();
  constexpr size_t smem = rows_smem_floats<D>(KR, 2, kBK, 2) * sizeof(float);
  if (int rc = set_smem(flash_diffusion_dkv_kernel<T, D>, smem)) return rc;
  const dim3 grid((a.Sk + KR - 1) / KR, a.hkv, a.B);
  flash_diffusion_dkv_kernel<T, D><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const T*>(dout),
      lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), a);
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
