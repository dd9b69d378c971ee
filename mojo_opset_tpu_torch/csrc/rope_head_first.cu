// Kernel M: rotate-half RoPE over a strided head-first view, q and k in
// one launch, forward or (with the sign of sin flipped) backward.
//
// Replaces the JAX package's backends/pallas/kernels/rope.py:97
// (rope_head_first, body _head_first_kernel :84 and _half_slice :72, call
// :112) and rope.py:128 (rope_train, whose backward :153-159 is the same
// kernel with -sin):
//   out[..., :D/2] = x_lo * c_lo - x_hi * s_lo
//   out[..., D/2:] = x_hi * c_hi + x_lo * s_hi
// with s = -sin for the backward (rotate-half is a rotation: R^T = -R).
//
// x is viewed as (B, H, S, D) with any strides on B, H and S and unit stride
// on D; the output has strides of its own (the wrapper allocates it like
// x), and the cos/sin tables are (S, D), or (B, S, D) with a batch stride,
// in x's dtype or in fp32. So one kernel serves head-first (B, H, S, D), the
// training forward's token-first (B, S, H, D) through a transposed view
// (no copy on the way to kernel J's packed rows), and (T, H, D) as B = 1.
//
// Bound on the H100: bytes (read q, k and the tables, write the outputs; 6
// FLOPs per pair). Design: one thread per G neighbouring pairs (j..j+G-1 of
// the low half and their partners in the high half) of one (b, h, s) row;
// neighbouring threads take neighbouring j, so loads and stores are
// coalesced; G = 4 when the strides and pointers allow vector loads. Math
// in fp32, one rounding at the store.
#include "common.cuh"

namespace {

constexpr int kRopeThreads = 256;

// element strides of the b, h and s axes of q, k, their outputs, and the
// tables' b and s strides
struct RopeStrides {
  int64_t q[3], k[3], qo[3], ko[3], tab[2];
};

template <typename T, typename TT, int G>
__global__ void __launch_bounds__(kRopeThreads)
rope_strided_kernel(const T* __restrict__ q, const T* __restrict__ k, const TT* __restrict__ cos_t,
                    const TT* __restrict__ sin_t, T* __restrict__ q_out, T* __restrict__ k_out, RopeStrides st,
                    int B, int S, int hq, int hk, int D, float sin_sign) {
  const int half = D / 2;
  const unsigned gpr = static_cast<unsigned>(half / G);  // groups of G pairs per row
  const unsigned q_groups = static_cast<unsigned>(B) * hq * S * gpr;
  const unsigned total = q_groups + static_cast<unsigned>(B) * hk * S * gpr;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const bool is_q = i < q_groups;
    const unsigned local = is_q ? i : i - q_groups;
    const unsigned heads = is_q ? hq : hk;
    const int j = static_cast<int>(local % gpr) * G;
    const unsigned row = local / gpr;  // (b * heads + h) * S + s
    const int s = static_cast<int>(row % S);
    const unsigned bh = row / S;
    const int h = static_cast<int>(bh % heads);
    const int b = static_cast<int>(bh / heads);
    // strides picked by value: a pointer into the parameter struct would move it to local memory
    const T* x = is_q ? q + b * st.q[0] + h * st.q[1] + s * st.q[2] : k + b * st.k[0] + h * st.k[1] + s * st.k[2];
    T* o = is_q ? q_out + b * st.qo[0] + h * st.qo[1] + s * st.qo[2]
                : k_out + b * st.ko[0] + h * st.ko[1] + s * st.ko[2];
    const int64_t t_off = b * st.tab[0] + s * st.tab[1];
    float x_lo[G], x_hi[G], c_lo[G], c_hi[G], s_lo[G], s_hi[G], lo[G], hi[G];
    mojo_load_row<T, G>(x + j, x_lo);
    mojo_load_row<T, G>(x + j + half, x_hi);
    mojo_load_row<TT, G>(cos_t + t_off + j, c_lo);
    mojo_load_row<TT, G>(cos_t + t_off + j + half, c_hi);
    mojo_load_row<TT, G>(sin_t + t_off + j, s_lo);
    mojo_load_row<TT, G>(sin_t + t_off + j + half, s_hi);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      lo[e] = x_lo[e] * c_lo[e] - x_hi[e] * (sin_sign * s_lo[e]);
      hi[e] = x_hi[e] * c_hi[e] + x_lo[e] * (sin_sign * s_hi[e]);
    }
    mojo_store_row<T, G>(o + j, lo);
    mojo_store_row<T, G>(o + j + half, hi);
  }
}

template <typename T, typename TT>
void launch_rope(const void* q, const void* k, const void* cos_t, const void* sin_t, void* q_out, void* k_out,
                 const RopeStrides& st, int B, int S, int hq, int hk, int D, float sin_sign, int vec,
                 cudaStream_t stream) {
  const int G = vec ? 4 : 1;
  const int64_t total = static_cast<int64_t>(B) * (hq + hk) * S * (D / 2 / G);
  const int64_t want = (total + kRopeThreads - 1) / kRopeThreads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);  // grid-stride past 16 per SM
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const TT* ct = static_cast<const TT*>(cos_t);
  const TT* snt = static_cast<const TT*>(sin_t);
  if (vec) {
    rope_strided_kernel<T, TT, 4><<<blocks, kRopeThreads, 0, stream>>>(
        qt, kt, ct, snt, static_cast<T*>(q_out), static_cast<T*>(k_out), st, B, S, hq, hk, D, sin_sign);
  } else {
    rope_strided_kernel<T, TT, 1><<<blocks, kRopeThreads, 0, stream>>>(
        qt, kt, ct, snt, static_cast<T*>(q_out), static_cast<T*>(k_out), st, B, S, hq, hk, D, sin_sign);
  }
}

}  // namespace

// q (B, hq, S, D), k (B, hk, S, D) and their outputs in `dtype`, with unit
// stride on D; `strides` (host memory): 14 element strides, the b, h and s
// strides of q, k, q_out and k_out, then the tables' b stride (0 for (S, D)
// tables) and s stride. cos/sin in `dtype`, or fp32 when `tab_f32`. D even;
// B * (hq + hk) * S * D / 2 < 2^31. `vec` = 1 when D / 2, every stride and
// every pointer allow 4-element vectors. `negate_sin` = 1 gives the backward.
extern "C" int mojo_rope_head_first(const void* q, const void* k, const void* cos_t, const void* sin_t,
                                    void* q_out, void* k_out, const long long* strides, int B, int S, int hq,
                                    int hk, int D, int tab_f32, int negate_sin, int vec, int dtype, void* stream) {
  if (static_cast<int64_t>(B) * (hq + hk) * S * D <= 0) return static_cast<int>(cudaSuccess);
  RopeStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.qo[i] = strides[6 + i];
    st.ko[i] = strides[9 + i];
  }
  st.tab[0] = strides[12];
  st.tab[1] = strides[13];
  const float sign = negate_sin ? -1.f : 1.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    if (tab_f32) {
      launch_rope<T, float>(q, k, cos_t, sin_t, q_out, k_out, st, B, S, hq, hk, D, sign, vec, s);
    } else {
      launch_rope<T, T>(q, k, cos_t, sin_t, q_out, k_out, st, B, S, hq, hk, D, sign, vec, s);
    }
  });
  return static_cast<int>(cudaGetLastError());
}
