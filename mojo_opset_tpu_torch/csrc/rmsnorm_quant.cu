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
// few FLOPs per element.
// At the widths the models use (norms.row_layout, the layouts of kernel A
// in row_regs.cuh: D = 2560 bf16 is a warp of 10 16-byte vectors a lane,
// 5120 two warps of 10) the register kernel reads each row once into
// registers over TPR lanes, none idle. The sum of squares reduces over the
// row's lanes by xor shuffles, then a row of several warps adds the warps'
// sums in order through shared memory, as A does; the normed values stay in
// registers, and their amax reduces the same way (max has no order). The
// fp32 weight and smooth scale are read as 16-byte vectors; each 16-byte x
// vector becomes one 8-byte (bf16/fp16) or 4-byte (fp32) int8 store, and
// the row's first lane stores its scale. A lane's 80 values at the model
// widths made the int8 step the long pole: it runs as RowQuant, the
// division's bits from Newton corrections of the row's reciprocal and the
// rounding by an addition, on the FMA and integer pipes alone, and the amax
// over four chains. The grid is A's: at most the blocks the card holds at
// once (four an SM, kRqRegMinBlocks), each taking the same number of row
// groups.
// Other widths, unaligned pointers and limits that are not integers within
// int8's range take the generic kernel: one 256-thread block a row, the
// row in registers between two block reductions, loads of 16 bytes a
// thread when the row allows it.
#include "common.cuh"
#include "row_regs.cuh"

namespace {

// The generic kernel: one 256-thread block a row
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

// The register kernel: TPR threads a row, VPT 16-byte vectors each, D = TPR * VPT * (16 / sizeof(T)) exactly;
// block b takes row groups b, b + gridDim.x, ...
constexpr int kRqRegThreads = 128;
// four blocks an SM (128 registers a thread): 1650 rows of 2560 then take one round of the grid, not two
constexpr int kRqRegMinBlocks = 4;

// v reduced over the TPR lanes of this thread's row: xor shuffles within the warp, then for a row of several
// warps the warps' values in order through `buf` (one slot a warp). Every lane of the block calls it.
template <bool MAX, int TPR>
__device__ __forceinline__ float row_reduce(float v, float* buf, int row_in_block) {
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = MAX ? fmaxf(v, other) : v + other;
  }
  if constexpr (TPR > 32) {
    constexpr int WARPS = TPR / 32;
    if (threadIdx.x % 32 == 0) buf[threadIdx.x / 32] = v;
    __syncthreads();
    const float* row_buf = buf + row_in_block * WARPS;
    v = row_buf[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) v = MAX ? fmaxf(v, row_buf[i]) : v + row_buf[i];
  }
  return v;
}

// VEC / 4 16-byte vectors of fp32 at p (16-byte aligned) into f
template <int VEC>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, float (&f)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC / 4; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + k);
    f[4 * k] = v.x;
    f[4 * k + 1] = v.y;
    f[4 * k + 2] = v.z;
    f[4 * k + 3] = v.w;
  }
}

// The register kernel's int8 step: exactly clamp(rintf(n / scale), q_min, q_max) for integer limits (the wrapper
// sends others to the generic kernel), in fewer and shorter dependent steps than the division, rintf and the float
// to int conversion. n / scale comes from the row's correctly rounded reciprocal and two fused corrections, which
// give the correctly rounded quotient (Markstein's theorem: the reciprocal of a normal scale below 2^126 is normal,
// and a residual that matters does not underflow), so it equals the division; a row whose scale is larger (an
// infinite normed value, or q_max below 2) divides. Adding 1.5 * 2^23 rounds the quotient half to even (that sum's ulp is 1); the
// clamp happens there, and the sum's low byte is the int8 value.
constexpr float kRound = 12582912.f;  // 1.5 * 2^23

struct RowQuant {
  float scale, rcp, lo, hi;  // lo, hi: the limits + kRound

  // the bits of kRound + clamp(rint(n / scale)): the value's int8 in the low byte
  template <bool NEWTON>
  __device__ __forceinline__ unsigned bits(float n) const {
    float quot;
    if constexpr (NEWTON) {
      const float q0 = __fmul_rn(n, rcp);
      const float q1 = __fmaf_rn(__fmaf_rn(-q0, scale, n), rcp, q0);
      quot = __fmaf_rn(__fmaf_rn(-q1, scale, n), rcp, q1);
    } else {
      quot = n / scale;
    }
    return __float_as_uint(fminf(fmaxf(__fadd_rn(quot, kRound), lo), hi));
  }

  // four values' int8s packed in one word, the first lowest
  template <bool NEWTON>
  __device__ __forceinline__ unsigned pack4(const float* n) const {
    return __byte_perm(__byte_perm(bits<NEWTON>(n[0]), bits<NEWTON>(n[1]), 0x0040),
                       __byte_perm(bits<NEWTON>(n[2]), bits<NEWTON>(n[3]), 0x0040), 0x5410);
  }

  // a row's VPT vectors of VEC normed values, lane `sub` of TPR, stored as int8 at qr: one store a vector
  template <bool NEWTON, int TPR, int VPT, int VEC>
  __device__ __forceinline__ void store(const float (&n)[VPT][VEC], int8_t* __restrict__ qr, int sub) const {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      int8_t* dst = qr + (i * TPR + sub) * VEC;
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack4<NEWTON>(n[i]), pack4<NEWTON>(n[i] + 4));
      } else {
        *reinterpret_cast<unsigned int*>(dst) = pack4<NEWTON>(n[i]);
      }
    }
  }
};

template <typename T, int TPR, int VPT>
__global__ void __launch_bounds__(kRqRegThreads, kRqRegMinBlocks)
rmsnorm_quant_regs_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ smooth,
                          int8_t* __restrict__ q, float* __restrict__ scale_out, int rows, float eps, float q_min,
                          float q_max) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  constexpr int D = TPR * VPT * VEC;
  constexpr int RPB = kRqRegThreads / TPR;  // rows a block takes at a time
  static_assert(kRqRegThreads % TPR == 0 && (TPR <= 32 ? 32 % TPR == 0 : TPR % 32 == 0), "row split");
  // one slot a warp for each reduction. A slot is written again only after a barrier that every lane reaches after
  // reading it (the sums' after the amax's barrier, the amax's after the next group's sums' barrier), so each
  // reduction needs one barrier
  __shared__ float warp_ss[kRqRegThreads / 32], warp_amax[kRqRegThreads / 32];
  const int sub = threadIdx.x % TPR, row_in_block = threadIdx.x / TPR;
  const int groups = (rows + RPB - 1) / RPB;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int row = grp * RPB + row_in_block;
    const bool ok = row < rows;  // every lane joins the reductions; a row past the end loads and stores nothing
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * D);
    uint4 v[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) v[i] = ok ? __ldcs(xr + i * TPR + sub) : make_uint4(0, 0, 0, 0);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const T* t = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = mojo_to_float(t[k]);
        ss += f * f;
      }
    }
    ss = row_reduce<false, TPR>(ss, warp_ss, row_in_block);
    const float inv = 1.f / sqrtf(ss / D + eps);

    float n[VPT][VEC];
    float amax4[4] = {};  // four chains: max has no order
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (i * TPR + sub) * VEC;
      const T* t = reinterpret_cast<const T*>(&v[i]);
      float wv[VEC];
      load_f32<VEC>(w + c, wv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) n[i][k] = (mojo_to_float(t[k]) * inv) * wv[k];
      if (smooth != nullptr) {
        load_f32<VEC>(smooth + c, wv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) n[i][k] = n[i][k] * wv[k];
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) amax4[k % 4] = fmaxf(amax4[k % 4], fabsf(n[i][k]));
    }
    const float amax = fmaxf(fmaxf(amax4[0], amax4[1]), fmaxf(amax4[2], amax4[3]));
    const float scale = fmaxf(row_reduce<true, TPR>(amax, warp_amax, row_in_block), 1e-12f) / q_max;
    if (!ok) continue;
    if (sub == 0) scale_out[row] = scale;
    const RowQuant quant{scale, __frcp_rn(scale), q_min + kRound, q_max + kRound};
    int8_t* qr = q + static_cast<int64_t>(row) * D;
    if (scale < 0x1p126f) {
      quant.store<true, TPR>(n, qr, sub);
    } else {
      quant.store<false, TPR>(n, qr, sub);
    }
  }
}

template <typename T, int TPR, int VPT>
int launch_regs(const T* x, const float* w, const float* smooth, int8_t* q, float* s, int rows, float eps,
                float q_min, float q_max, cudaStream_t stream) {
  static const int resident = mojo_resident_blocks(rmsnorm_quant_regs_kernel<T, TPR, VPT>, kRqRegThreads);
  constexpr int RPB = kRqRegThreads / TPR;
  const int groups = (rows + RPB - 1) / RPB;
  rmsnorm_quant_regs_kernel<T, TPR, VPT><<<mojo_even_rounds_grid(groups, resident), kRqRegThreads, 0, stream>>>(
      x, w, smooth, q, s, rows, eps, q_min, q_max);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_regs(const void* x, const float* w, const float* smooth, int8_t* q, float* s, int rows, float eps,
                  float q_min, float q_max, int tpr, int vpt, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
#define MOJO_ROW_CASE(TPR, VPT) \
  if (tpr == TPR && vpt == VPT) return launch_regs<T, TPR, VPT>(xt, w, smooth, q, s, rows, eps, q_min, q_max, stream);
  MOJO_ROW_LAYOUTS(MOJO_ROW_CASE)
#undef MOJO_ROW_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x: (rows, D) contiguous in `dtype`; w and smooth (nullable): (D,) fp32;
// q: (rows, D) int8; scale: (rows,) fp32. `vec` = 1 when D is a multiple of
// 16 bytes' worth of x's elements and x is 16-byte aligned. tpr > 0 (with
// vec, and w and smooth 16-byte aligned) takes the register kernel with tpr
// threads of vpt 16-byte vectors a row (norms.row_layout), D = tpr * vpt *
// 16 / sizeof(dtype); tpr = 0 the generic kernel, D <= 8192.
extern "C" int mojo_rmsnorm_quant(const void* x, const void* w, const void* smooth, void* q, void* scale,
                                  int rows, int D, float eps, float q_min, float q_max, int vec, int tpr, int vpt,
                                  int dtype, void* stream) {
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
    if (tpr > 0) {
      const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(smooth) % 16 == 0;
      if (vec && aligned && D == tpr * vpt * V) {
        rc = dispatch_regs<T>(x, wf, sm, qo, so, rows, eps, q_min, q_max, tpr, vpt, s);
      }
    } else {
      rc = vec ? launch_rmsnorm_quant<T, V>(xt, wf, sm, qo, so, rows, D, eps, q_min, q_max, s)
               : launch_rmsnorm_quant<T, 1>(xt, wf, sm, qo, so, rows, D, eps, q_min, q_max, s);
    }
  });
  return rc;
}
