// Kernel B: rotate-half RoPE on token-first q and k, (T, H, D), with
// cos/sin tables (T, D) in the same dtype.
//
// Replaces the JAX package's backends/pallas/kernels/rope.py:166
// (rope_token_first, body _token_first_kernel :89 and _half_slice :72):
//   out[..., :D/2] = x_lo * c_lo - x_hi * s_lo
//   out[..., D/2:] = x_hi * c_hi + x_lo * s_hi
//
// Bound on the H100: bytes (read x and the tables, write out; 6 FLOPs per
// pair). Design: one thread per (token, head, i < D/2) pair of one launch
// that covers q and k together, so a layer pays one launch; neighbouring
// threads take neighbouring i, so every load and store is coalesced. Math
// in fp32, one rounding at the store. Any T: no row-block condition.
#include "common.cuh"

namespace {

constexpr int kRopeThreads = 256;

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
    o[j] = mojo_from_float<T>(x_lo * mojo_to_float(c[j]) - x_hi * mojo_to_float(s[j]));
    o[j + half] = mojo_from_float<T>(x_hi * mojo_to_float(c[j + half]) + x_lo * mojo_to_float(s[j + half]));
  }
}

}  // namespace

// q (T, hq, D), k (T, hk, D), cos/sin (T, D), outputs like q and k; all
// contiguous in `dtype`; D even.
extern "C" int mojo_rope_token_first(const void* q, const void* k, const void* cos_t, const void* sin_t,
                                     void* q_out, void* k_out, int n_tokens, int hq, int hk, int D,
                                     int dtype, void* stream) {
  const int64_t total = static_cast<int64_t>(n_tokens) * (hq + hk) * (D / 2);
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const int64_t want = (total + kRopeThreads - 1) / kRopeThreads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);  // grid-stride past 32 per SM
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rope_token_first_kernel<T><<<blocks, kRopeThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(cos_t),
        static_cast<const T*>(sin_t), static_cast<T*>(q_out), static_cast<T*>(k_out), n_tokens, hq, hk, D);
  });
  return static_cast<int>(cudaGetLastError());
}
