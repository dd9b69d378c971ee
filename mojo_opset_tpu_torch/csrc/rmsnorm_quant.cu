// Kernel E: RMSNorm fused with per-token symmetric int8 quant.
//
// Replaces the JAX package's backends/pallas/kernels/norms.py:131
// (rmsnorm_quant, body _rmsnorm_quant_kernel :120, call :140).
//
// normed = ((x * rsqrt(mean(x^2) + eps)) * w) [* smooth] in fp32;
// scale = max(amax|normed|, 1e-12) / q_max; q = clamp(rint(normed / scale),
// q_min, q_max). rintf rounds half to even, as jnp.round and torch.round
// do (CUDA's roundf rounds half away from zero), and the kernel divides by
// the scale as the golden does, so a tie lands where it lands there.
//
// Bound on the H100: bytes. A row is read once (2 bytes per element in
// bf16) and written once as int8 plus one fp32 scale; the arithmetic is a
// few FLOPs per element. Design: one 256-thread block per row. The row
// stays in registers between the two block reductions (sum of squares,
// then amax), so x crosses device memory once; loads are 16 bytes per
// thread when the row allows it, and the int8 stores VEC bytes.
#include "common.cuh"

namespace {

constexpr int kRqThreads = 256;
constexpr int kRqWarps = kRqThreads / 32;
constexpr int kRqMaxChunks = 32;  // chunks per thread: D <= 8192 on the scalar path

template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = MAX ? mojo_warp_max(v) : mojo_warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kRqWarps; ++i) r = MAX ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

// NJ chunks of VEC consecutive elements per thread; chunk j of thread t
// starts at element (t + j * kRqThreads) * VEC.
template <typename T, int VEC, int NJ>
__global__ void __launch_bounds__(kRqThreads)
rmsnorm_quant_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ smooth,
                     int8_t* __restrict__ q, float* __restrict__ scale_out, int D, float eps, float q_min,
                     float q_max) {
  __shared__ float red[kRqWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  float v[NJ][VEC];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = (threadIdx.x + j * kRqThreads) * VEC;
    if (c < D) {
      mojo_load_row<T, VEC>(xr + c, v[j]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += v[j][e] * v[j][e];
    }
  }
  const float inv = 1.f / sqrtf(block_reduce<false>(ss, red) / D + eps);

  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = (threadIdx.x + j * kRqThreads) * VEC;
    if (c < D) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float n = (v[j][e] * inv) * w[c + e];
        if (smooth != nullptr) n = n * smooth[c + e];
        v[j][e] = n;
        amax = fmaxf(amax, fabsf(n));
      }
    }
  }
  const float scale = fmaxf(block_reduce<true>(amax, red), 1e-12f) / q_max;
  if (threadIdx.x == 0) scale_out[row] = scale;

  int8_t* qr = q + row * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = (threadIdx.x + j * kRqThreads) * VEC;
    if (c < D) {
      unsigned int packed[(VEC + 3) / 4] = {};
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int qi = static_cast<int>(fminf(fmaxf(rintf(v[j][e] / scale), q_min), q_max));
        if constexpr (VEC >= 4) {
          packed[e / 4] |= (static_cast<unsigned int>(qi) & 0xffu) << (8 * (e % 4));
        } else {
          qr[c + e] = static_cast<int8_t>(qi);
        }
      }
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(packed[0], packed[1]);
      } else if constexpr (VEC == 4) {
        *reinterpret_cast<unsigned int*>(qr + c) = packed[0];
      }
    }
  }
}

template <typename T, int VEC>
int launch_rmsnorm_quant(const T* x, const float* w, const float* smooth, int8_t* q, float* s, int rows, int D,
                         float eps, float q_min, float q_max, cudaStream_t stream) {
  const int per_thread = ((D + VEC - 1) / VEC + kRqThreads - 1) / kRqThreads;
#define MOJO_RQ_LAUNCH(NJ)                                                                          \
  rmsnorm_quant_kernel<T, VEC, NJ><<<rows, kRqThreads, 0, stream>>>(x, w, smooth, q, s, D, eps, q_min, \
                                                                     q_max)
  if (per_thread <= 1) {
    MOJO_RQ_LAUNCH(1);
  } else if (per_thread <= 2) {
    MOJO_RQ_LAUNCH(2);
  } else if (per_thread <= 4) {
    MOJO_RQ_LAUNCH(4);
  } else if (per_thread <= 8) {
    MOJO_RQ_LAUNCH(8);
  } else if (per_thread <= 16) {
    MOJO_RQ_LAUNCH(16);
  } else if (per_thread <= kRqMaxChunks) {
    MOJO_RQ_LAUNCH(kRqMaxChunks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MOJO_RQ_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, D) contiguous in `dtype`; w and smooth (nullable): (D,) fp32;
// q: (rows, D) int8; scale: (rows,) fp32. `vec` = 1 when D is a multiple of
// 16 bytes' worth of x's elements and x is 16-byte aligned. D <= 8192.
extern "C" int mojo_rmsnorm_quant(const void* x, const void* w, const void* smooth, void* q, void* scale,
                                  int rows, int D, float eps, float q_min, float q_max, int vec, int dtype,
                                  void* stream) {
  if (rows <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sm = static_cast<const float*>(smooth);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    const T* xt = static_cast<const T*>(x);
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    rc = vec ? launch_rmsnorm_quant<T, V>(xt, wf, sm, qo, so, rows, D, eps, q_min, q_max, s)
             : launch_rmsnorm_quant<T, 1>(xt, wf, sm, qo, so, rows, D, eps, q_min, q_max, s);
  });
  return rc;
}
