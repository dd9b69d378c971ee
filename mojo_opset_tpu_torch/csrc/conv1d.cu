// Kernel Q: causal depthwise conv1d (+ bias, + SiLU) forward and backward, over
// the stream [state rows -(W-1)..-1] ++ x:
//   z[t]   = b + sum_w stream[t + w] * k[w]      (k[W-1] multiplies the newest row)
//   out[t] = act(z[t])
// and from the output gradient g:
//   dz[t]  = g[t] * silu'(z[t])  (g[t] without the activation)
//   dx[j]  = sum_w dz[j + (W-1) - w] * k[w]       (dz = 0 past T)
//   dw[w]  = sum over (b, t) of dz[t] * stream[t + w];  db = sum of dz
//
// Replaces the JAX package's backends/pallas/kernels/conv1d_vjp.py:212
// (conv1d_train: _fwd_kernel :73, call :149; _bwd_kernel :88, call :188).
//
// Bound on the H100: bytes. The forward reads x and writes out; the backward
// reads x and g and writes dx; each does ~2W FLOPs an element.
// Design: a thread owns V neighbouring channels (a vector load; neighbouring
// threads take neighbouring channels) and walks a chunk of kChunk time rows,
// the last W rows of the stream in registers, so each row is read once. The
// taps and the bias live in registers; W is a runtime value up to MAXW (4 or
// kMaxW), the taps right-aligned in MAXW slots with zeros below, so every
// register index is static. The MAXW = 4 instantiation pays for itself: the
// kMaxW one at W = 4 takes 1.7x the forward's time and 2.2x the backward's
// on an H100 at B 8, T 8192, D 2048 (benchmark/conv1d_window_ab.py). A chunk reads its W-1 halo rows itself: from x,
// or from the state for stream rows t < 0 (the TPU kernel gathered them on
// the host into side arrays); the backward also recomputes the W-1 dz rows
// after its chunk for dx. dw and db: blocks run in no order, so each block
// (channel group, slot) walks a fixed set of chunks, keeps fp32 sums in
// registers and writes them as one partial row; common.cuh's column sum
// adds the slots' rows in order. No atomics: the same shape gives the same
// chunk sets and the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;  // time rows of a chunk
constexpr int kMaxW = 16;

// Stream row u of one sequence: x row u for 0 <= u < T, state row W-1+u for
// -(W-1) <= u < 0.
template <typename T, int V>
__device__ __forceinline__ void stream_row(const T* __restrict__ xs, const T* __restrict__ ss, int u, int W, int D,
                                           float (&f)[V]) {
  if (u >= 0) {
    mojo_load_row<T, V>(xs + static_cast<int64_t>(u) * D, f);
  } else {
    mojo_load_row<T, V>(ss + static_cast<int64_t>(W - 1 + u) * D, f);
  }
}

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

// taps of channels c..c+V-1 of the fp32 (D, W) weight: right-aligned
// (kr[MAXW - W + w] = k[w]) and, when kl is given, left-aligned (kl[w])
template <int MAXW, int V>
__device__ __forceinline__ void load_taps(const float* __restrict__ w, int c, int W, float (&kr)[MAXW][V],
                                          float (&kl)[MAXW][V]) {
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* wc = w + static_cast<int64_t>(c + v) * W;
      kr[i][v] = i >= MAXW - W ? wc[i - (MAXW - W)] : 0.f;
      kl[i][v] = i < W ? wc[i] : 0.f;
    }
  }
}

// drop the oldest row of a right-aligned window of the last W rows: slots
// below MAXW - W stay zero, so a zero tap never meets an old inf
template <int MAXW, int V>
__device__ __forceinline__ void shift_window(float (&win)[MAXW][V], int W) {
#pragma unroll
  for (int i = 0; i < MAXW - 1; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) win[i][v] = i >= MAXW - W ? win[i + 1][v] : 0.f;
  }
}

// xw[MAXW - W .. MAXW - 2] = stream rows t0 - (W-1) .. t0 - 1, the rest zero
template <typename T, int MAXW, int V>
__device__ __forceinline__ void load_halo(const T* __restrict__ xs, const T* __restrict__ ss, int t0, int W, int D,
                                          float (&xw)[MAXW][V]) {
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i >= MAXW - W && i < MAXW - 1) {
      stream_row<T, V>(xs, ss, t0 - (MAXW - 1) + i, W, D, xw[i]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) xw[i][v] = 0.f;
    }
  }
}

template <int MAXW, int V>
__device__ __forceinline__ void conv_row(const float (&xw)[MAXW][V], const float (&kr)[MAXW][V],
                                         const float (&bv)[V], float (&z)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) z[v] = bv[v];
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) z[v] += xw[i][v] * kr[i][v];
  }
}

template <typename T, int MAXW, int V>
__global__ void __launch_bounds__(kThreads)
conv1d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ state, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int Tn, int D, int W, int act) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= D) return;
  const int t0 = blockIdx.y * kChunk, b = blockIdx.z;
  const T* xs = x + static_cast<int64_t>(b) * Tn * D + c;
  const T* ss = state + static_cast<int64_t>(b) * (W - 1) * D + c;
  T* os = out + static_cast<int64_t>(b) * Tn * D + c;
  float kr[MAXW][V], kl[MAXW][V], bv[V], xw[MAXW][V];
  load_taps<MAXW, V>(w, c, W, kr, kl);
#pragma unroll
  for (int v = 0; v < V; ++v) bv[v] = bias != nullptr ? bias[c + v] : 0.f;
  load_halo<T, MAXW, V>(xs, ss, t0, W, D, xw);
  const int t_end = min(t0 + kChunk, Tn);
#pragma unroll 2
  for (int t = t0; t < t_end; ++t) {
    stream_row<T, V>(xs, ss, t, W, D, xw[MAXW - 1]);
    float z[V];
    conv_row<MAXW, V>(xw, kr, bv, z);
    if (act) {
#pragma unroll
      for (int v = 0; v < V; ++v) z[v] *= sigmoid(z[v]);
    }
    mojo_store_row<T, V>(os + static_cast<int64_t>(t) * D, z);
    shift_window<MAXW, V>(xw, W);
  }
}

template <typename T, int MAXW, int V>
__global__ void __launch_bounds__(kThreads)
conv1d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ state, const float* __restrict__ w,
                  const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dx,
                  float* __restrict__ part, int B, int Tn, int D, int W, int act) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= D) return;
  const int slot = blockIdx.y, slots = gridDim.y;
  const int n_chunks = (Tn + kChunk - 1) / kChunk;
  float kr[MAXW][V], kl[MAXW][V], bv[V], dwr[MAXW][V], db[V];
  load_taps<MAXW, V>(w, c, W, kr, kl);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    bv[v] = bias != nullptr ? bias[c + v] : 0.f;
    db[v] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) dwr[i][v] = 0.f;
  }
  for (int q = slot; q < B * n_chunks; q += slots) {
    const int b = q / n_chunks, t0 = (q % n_chunks) * kChunk;
    const int t_own = min(t0 + kChunk, Tn);  // rows [t0, t_own) get their dx, dw and db terms here
    const int64_t seq = static_cast<int64_t>(b) * Tn * D + c;
    const T* xs = x + seq;
    const T* gs = g + seq;
    const T* ss = state + static_cast<int64_t>(b) * (W - 1) * D + c;
    T* dxs = dx + seq;
    float xw[MAXW][V], dzw[MAXW][V];  // the last W stream rows and dz rows, newest at MAXW - 1
    load_halo<T, MAXW, V>(xs, ss, t0, W, D, xw);
#pragma unroll
    for (int i = 0; i < MAXW; ++i) {
#pragma unroll
      for (int v = 0; v < V; ++v) dzw[i][v] = 0.f;
    }
    for (int tp = t0; tp < t_own + W - 1; ++tp) {
      shift_window<MAXW, V>(dzw, W);
      if (tp < Tn) {
        stream_row<T, V>(xs, ss, tp, W, D, xw[MAXW - 1]);
        float gv[V];
        mojo_load_row<T, V>(gs + static_cast<int64_t>(tp) * D, gv);
        if (act) {
          float z[V];
          conv_row<MAXW, V>(xw, kr, bv, z);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float s = sigmoid(z[v]);
            dzw[MAXW - 1][v] = gv[v] * (s * (1.f + z[v] * (1.f - s)));
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) dzw[MAXW - 1][v] = gv[v];
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) dzw[MAXW - 1][v] = 0.f;
      }
      if (tp < t_own) {  // dw[w] takes dz[tp] * stream[tp + w], the window's slot MAXW - W + w
#pragma unroll
        for (int i = 0; i < MAXW; ++i) {
#pragma unroll
          for (int v = 0; v < V; ++v) dwr[i][v] += dzw[MAXW - 1][v] * xw[i][v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) db[v] += dzw[MAXW - 1][v];
      }
      const int j = tp - (W - 1);  // dx[j] = sum_w dz[tp - w] * k[w]
      if (j >= t0) {
        float d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) d[v] = 0.f;
#pragma unroll
        for (int i = 0; i < MAXW; ++i) {
#pragma unroll
          for (int v = 0; v < V; ++v) d[v] += dzw[MAXW - 1 - i][v] * kl[i][v];
        }
        mojo_store_row<T, V>(dxs + static_cast<int64_t>(j) * D, d);
      }
      if (tp < Tn) shift_window<MAXW, V>(xw, W);
    }
  }
  // this slot's partial row: (W + 1, D), dw rows then db
  float* ps = part + static_cast<int64_t>(slot) * (W + 1) * D + c;
#pragma unroll
  for (int i = 0; i < MAXW; ++i) {
    if (i >= MAXW - W) {
#pragma unroll
      for (int v = 0; v < V; ++v) ps[static_cast<int64_t>(i - (MAXW - W)) * D + v] = dwr[i][v];
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) ps[static_cast<int64_t>(W) * D + v] = db[v];
}

// channels a thread owns: a 16-byte vector for the forward with W <= 4, less
// where W's registers are many (the window and the taps hold MAXW x V floats)
template <typename T, int MAXW, bool BWD>
constexpr int vec_width() {
  constexpr int bytes = MAXW <= 4 ? (BWD ? 8 : 16) : (BWD ? 1 : 4);
  return bytes / static_cast<int>(sizeof(T)) > 0 ? bytes / static_cast<int>(sizeof(T)) : 1;
}

template <typename T, int MAXW, int V>
void launch_fwd(const void* x, const void* state, const float* w, const float* bias, void* out, int B, int Tn, int D,
                int W, int act, cudaStream_t stream) {
  const dim3 grid((D + kThreads * V - 1) / (kThreads * V), (Tn + kChunk - 1) / kChunk, B);
  conv1d_fwd_kernel<T, MAXW, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(state), w, bias, static_cast<T*>(out), Tn, D, W, act);
}

template <typename T, int MAXW, int V>
cudaError_t launch_bwd(const void* x, const void* state, const float* w, const float* bias, const void* g, void* dx,
                       float* part, float* dwb, int B, int Tn, int D, int W, int act, int slots, cudaStream_t stream) {
  const dim3 grid((D + kThreads * V - 1) / (kThreads * V), slots);
  conv1d_bwd_kernel<T, MAXW, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(state), w, bias, static_cast<const T*>(g),
      static_cast<T*>(dx), part, B, Tn, D, W, act);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int cols = (W + 1) * D;
  mojo_column_sum_kernel<><<<(cols + kMojoSumCols - 1) / kMojoSumCols, kMojoSumCols * kMojoSumSlices, 0, stream>>>(
      part, dwb, slots, cols);
  return cudaGetLastError();
}

}  // namespace

// x, out: (B, T, D) contiguous in `dtype`; state: (B, W-1, D) contiguous in
// `dtype` (the stream rows before x); w: (D, W) fp32; bias: (D,) fp32 or
// null. 1 <= W <= 16. `vec` = 1 when D is a multiple of 16 bytes' worth of
// elements and x, state, out are 16-byte aligned.
extern "C" int mojo_conv1d_fwd(const void* x, const void* state, const void* w, const void* bias, void* out, int B,
                               int T, int D, int W, int act, int vec, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  MOJO_DISPATCH_DTYPE(dtype, Tp, {
    if (W <= 4) {
      if (vec) {
        launch_fwd<Tp, 4, vec_width<Tp, 4, false>()>(x, state, wf, bf, out, B, T, D, W, act, s);
      } else {
        launch_fwd<Tp, 4, 1>(x, state, wf, bf, out, B, T, D, W, act, s);
      }
    } else if (vec) {
      launch_fwd<Tp, kMaxW, vec_width<Tp, kMaxW, false>()>(x, state, wf, bf, out, B, T, D, W, act, s);
    } else {
      launch_fwd<Tp, kMaxW, 1>(x, state, wf, bf, out, B, T, D, W, act, s);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

// x, g, dx: (B, T, D) contiguous in `dtype`; state, w, bias, W and vec as for
// the forward (vec also covers g and dx); part: (max_slots, W + 1, D) fp32
// scratch, of which the first min(max_slots, B * ceil(T / kChunk)) rows are
// used: the shape alone fixes the slots, so a call's bits repeat; dwb:
// (W + 1, D) fp32, dw's W rows then db.
extern "C" int mojo_conv1d_bwd(const void* x, const void* state, const void* w, const void* bias, const void* g,
                               void* dx, void* part, void* dwb, int B, int T, int D, int W, int act, int max_slots,
                               int vec, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || W < 1 || W > kMaxW || max_slots <= 0 || max_slots > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = static_cast<int64_t>(B) * ((T + kChunk - 1) / kChunk);
  const int slots = chunks < max_slots ? static_cast<int>(chunks) : max_slots;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(dwb);
  cudaError_t err = cudaSuccess;
  MOJO_DISPATCH_DTYPE(dtype, Tp, {
    if (W <= 4) {
      err = vec ? launch_bwd<Tp, 4, vec_width<Tp, 4, true>()>(x, state, wf, bf, g, dx, pf, of, B, T, D, W, act,
                                                              slots, s)
                : launch_bwd<Tp, 4, 1>(x, state, wf, bf, g, dx, pf, of, B, T, D, W, act, slots, s);
    } else {
      err = vec ? launch_bwd<Tp, kMaxW, vec_width<Tp, kMaxW, true>()>(x, state, wf, bf, g, dx, pf, of, B, T, D, W,
                                                                      act, slots, s)
                : launch_bwd<Tp, kMaxW, 1>(x, state, wf, bf, g, dx, pf, of, B, T, D, W, act, slots, s);
    }
  });
  return static_cast<int>(err);
}
