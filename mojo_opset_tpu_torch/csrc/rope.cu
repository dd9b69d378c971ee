// Kernel B: rotate-half RoPE on token-first q and k, (T, H, D), with
// cos/sin tables (T, D) in the same dtype.
//
// Replaces the JAX package's backends/pallas/kernels/rope.py:166
// (rope_token_first, body _token_first_kernel :89 and _half_slice :72):
//   out[..., :D/2] = x_lo * c_lo - x_hi * s_lo
//   out[..., D/2:] = x_hi * c_hi + x_lo * s_hi
// Math in fp32 (each product rounded, the second term's first, and summed
// with the first term's product in one fused multiply-add, written out so
// that both routes give the same bits), one rounding at the store. q and k
// go in one launch, so a layer pays one.
//
// Bound on the H100: bytes (read x and the tables, write out; 6 FLOPs per
// pair). The vector route (head dims 64 and 128, every pointer 16-byte
// aligned; rope.route): one covering grid, no grid-stride loop. A thread
// owns one 16-byte vector of the low half of one (token, head) row and the
// matching vector of the high half; rows go token by token (its hq q
// heads, then its hk k heads), so a token's heads sit in neighbouring
// threads and its cos/sin rows come from device memory once and from L1
// after that (read-only path, __ldg). All six loads are issued before any
// math; x is read and the output written with streaming hints (__ldcs,
// __stcs). VPH, the vectors a half row, is a template parameter, so the
// row and column come from a shift and a mask; the token is one 32-bit
// division by the heads a token. The generic route (any other even D, or
// an unaligned view) keeps a grid-stride loop of one thread per (token,
// head, i < D/2) pair, in 2-byte scalar loads and stores.
#include "common.cuh"

namespace {

constexpr int kRopeThreads = 256;  // the generic route's block

__device__ __forceinline__ float rot_lo(float x_lo, float x_hi, float c, float s) {
  return __fmaf_rn(x_lo, c, -__fmul_rn(x_hi, s));
}

__device__ __forceinline__ float rot_hi(float x_lo, float x_hi, float c, float s) {
  return __fmaf_rn(x_hi, c, __fmul_rn(x_lo, s));
}

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope_token_first_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ cos_t,
                        const T* __restrict__ sin_t, T* __restrict__ q_out, T* __restrict__ k_out,
                        int n_tokens, int hq, int hk, int D) {
  const int half = D / 2;
  const int64_t q_pairs = static_cast<int64_t>(n_tokens) * hq * half;
  const int64_t total = q_pairs + static_cast<int64_t>(n_tokens) * hk * half;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const bool is_q = i < q_pairs;
    const int64_t local = is_q ? i : i - q_pairs;
    const int heads = is_q ? hq : hk;
    const int j = static_cast<int>(local % half);
    const int64_t row = local / half;  // token * heads + head
    const int64_t t = row / heads;
    const T* x = (is_q ? q : k) + row * D;
    T* o = (is_q ? q_out : k_out) + row * D;
    const T* c = cos_t + t * D;
    const T* s = sin_t + t * D;
    const float x_lo = mojo_to_float(x[j]);
    const float x_hi = mojo_to_float(x[j + half]);
    o[j] = mojo_from_float<T>(rot_lo(x_lo, x_hi, mojo_to_float(c[j]), mojo_to_float(s[j])));
    o[j + half] = mojo_from_float<T>(rot_hi(x_lo, x_hi, mojo_to_float(c[j + half]), mojo_to_float(s[j + half])));
  }
}

// The vector route: thread g of the grid owns vector g % VPH of both halves of row g / VPH, of rows * VPH threads;
// every offset fits in 32 bits (the wrapper routes larger tensors to the generic kernel)
template <typename T, int VPH, int THREADS>
__global__ void __launch_bounds__(THREADS)
rope_token_first_vec_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ cos_t,
                            const T* __restrict__ sin_t, T* __restrict__ q_out, T* __restrict__ k_out,
                            unsigned rows, unsigned heads, unsigned hq) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr unsigned D = 2 * VPH * VEC;
  static_assert((VPH & (VPH - 1)) == 0, "VPH is a power of two");
  const unsigned g = blockIdx.x * THREADS + threadIdx.x;
  const unsigned row = g / VPH, col = g % VPH;
  if (row >= rows) return;
  const unsigned t = row / heads, h = row - t * heads;
  const bool is_q = h < hq;
  const unsigned x_row = is_q ? t * hq + h : t * (heads - hq) + (h - hq);
  const unsigned off = x_row * D + col * VEC;
  const uint4* xv = reinterpret_cast<const uint4*>((is_q ? q : k) + off);
  const uint4* cv = reinterpret_cast<const uint4*>(cos_t + t * D + col * VEC);
  const uint4* sv = reinterpret_cast<const uint4*>(sin_t + t * D + col * VEC);
  const uint4 lo = __ldcs(xv), hi = __ldcs(xv + VPH);
  const uint4 c_lo = __ldg(cv), c_hi = __ldg(cv + VPH), s_lo = __ldg(sv), s_hi = __ldg(sv + VPH);
  const T* xl = reinterpret_cast<const T*>(&lo);
  const T* xh = reinterpret_cast<const T*>(&hi);
  const T* cl = reinterpret_cast<const T*>(&c_lo);
  const T* ch = reinterpret_cast<const T*>(&c_hi);
  const T* sl = reinterpret_cast<const T*>(&s_lo);
  const T* sh = reinterpret_cast<const T*>(&s_hi);
  uint4 out_lo, out_hi;
  T* ol = reinterpret_cast<T*>(&out_lo);
  T* oh = reinterpret_cast<T*>(&out_hi);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float a = mojo_to_float(xl[e]), b = mojo_to_float(xh[e]);
    ol[e] = mojo_from_float<T>(rot_lo(a, b, mojo_to_float(cl[e]), mojo_to_float(sl[e])));
    oh[e] = mojo_from_float<T>(rot_hi(a, b, mojo_to_float(ch[e]), mojo_to_float(sh[e])));
  }
  uint4* ov = reinterpret_cast<uint4*>((is_q ? q_out : k_out) + off);
  __stcs(ov, out_lo);
  __stcs(ov + VPH, out_hi);
}

template <typename T, int VPH, int THREADS>
void launch_vec(const T* q, const T* k, const T* cos_t, const T* sin_t, T* q_out, T* k_out, int n_tokens, int hq,
                int hk, cudaStream_t stream) {
  const unsigned rows = static_cast<unsigned>(n_tokens) * static_cast<unsigned>(hq + hk);
  const unsigned blocks = (rows * VPH + THREADS - 1) / THREADS;
  rope_token_first_vec_kernel<T, VPH, THREADS><<<blocks, THREADS, 0, stream>>>(
      q, k, cos_t, sin_t, q_out, k_out, rows, static_cast<unsigned>(hq + hk), static_cast<unsigned>(hq));
}

// the vector route at head dim D (64 or 128) with `threads` (128 or 256) a block; false for another pair
template <typename T>
bool dispatch_vec(const T* q, const T* k, const T* cos_t, const T* sin_t, T* q_out, T* k_out, int n_tokens, int hq,
                  int hk, int D, int threads, cudaStream_t stream) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
#define MOJO_ROPE_CASE(WIDTH, THREADS)                                                                      \
  if (D == WIDTH && threads == THREADS) {                                                                   \
    launch_vec<T, WIDTH / 2 / VEC, THREADS>(q, k, cos_t, sin_t, q_out, k_out, n_tokens, hq, hk, stream); \
    return true;                                                                                            \
  }
  MOJO_ROPE_CASE(64, 128)
  MOJO_ROPE_CASE(64, 256)
  MOJO_ROPE_CASE(128, 128)
  MOJO_ROPE_CASE(128, 256)
#undef MOJO_ROPE_CASE
  return false;
}

}  // namespace

// q (T, hq, D), k (T, hk, D), cos/sin (T, D), outputs like q and k; all
// contiguous in `dtype`; D even. `vec` = 1 takes the vector route with
// `threads` a block (D 64 or 128, every pointer 16-byte aligned, q and k
// together under 2^31 elements: rope.route); vec = 0 the generic kernel.
extern "C" int mojo_rope_token_first(const void* q, const void* k, const void* cos_t, const void* sin_t,
                                     void* q_out, void* k_out, int n_tokens, int hq, int hk, int D, int vec,
                                     int threads, int dtype, void* stream) {
  const int64_t total = static_cast<int64_t>(n_tokens) * (hq + hk) * (D / 2);
  if (total <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* ct = static_cast<const T*>(cos_t);
    const T* st = static_cast<const T*>(sin_t);
    if (vec) {
      if (!dispatch_vec<T>(qt, kt, ct, st, static_cast<T*>(q_out), static_cast<T*>(k_out), n_tokens, hq, hk, D,
                           threads, s)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    } else {
      const int64_t want = (total + kRopeThreads - 1) / kRopeThreads;
      const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);  // grid-stride past 32 per SM
      rope_token_first_kernel<T><<<blocks, kRopeThreads, 0, s>>>(qt, kt, ct, st, static_cast<T*>(q_out),
                                                                  static_cast<T*>(k_out), n_tokens, hq, hk, D);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
