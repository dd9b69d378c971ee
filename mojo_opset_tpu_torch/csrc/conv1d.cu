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
// reads x and g and writes dx; each does ~2W FLOPs an element, and the
// SiLU's expf and division (a few tens of instructions an element) are a
// large share of the bytes' time, so the loads have to overlap them.
// Design: a thread owns V neighbouring channels (a 16-byte vector;
// neighbouring threads take neighbouring channels) and walks a chunk of time
// rows of one sequence, the last W-1 rows of the stream in registers, so
// each row is read once; the taps and the bias live in registers. Blocks
// are (channel group, slot): slot s walks the chunks s, s + slots, ... of
// all sequences in order, and the slots are as many as the card holds at
// once for the channel groups (the wrapper's conv1d_vjp.plan, from shapes
// alone; the launch bounds guarantee the blocks an SM it counts), each
// taking the same number of chunks. A chunk reads its W-1 halo rows itself:
// from x, or from the state for stream rows t < 0; the backward also
// recomputes the W-1 dz rows after its chunk for dx. dw and db: each block
// keeps fp32 sums in registers over its chunks and writes them as its
// slot's partial row; common.cuh's column sum adds the slots' rows in order.
// No atomics: the same shape gives the same chunks and the same bits.
//
// W <= 4 takes the exact-width kernels: W is a template parameter, so no
// tap is zero and the window's shifts are register renames, and the backward
// reads its taps from one copy. A thread loads R rows (of x, and of g in the
// backward) before it uses any of them: R 16-byte loads of each tensor in
// flight instead of one, with static register indices through a loop
// unrolled by R; loads carry the streaming hint (__ldcs) and stores write
// through (__stcs). Each z, dz and dx is summed in the taps' order, as the
// generic kernels sum them, so those bits do not depend on the route.
// W 5-16 takes the generic kernels: W a runtime value in kMaxW slots, the
// taps right-aligned with zeros below (the backward also keeps them
// left-aligned for dx), one row at a time; the forward covers its grid once
// with one block a (channel group, chunk, sequence).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // the generic kernels
constexpr int kMaxW = 16;
constexpr int kExactMaxW = 4;  // W <= 4: the exact-width kernels
constexpr int kRing = 4;       // the exact-width kernels' rows loaded ahead (conv1d_vjp.RING)
constexpr int kExactThreads = 128;
constexpr bool kPrefetch = true;  // the exact-width kernels load the next R rows before the current R rows' math

// blocks an SM an exact-width kernel of NT threads is built to hold: conv1d_vjp.blocks_per_sm mirrors it
template <bool BWD>
constexpr int exact_min_blocks(int threads) { return (BWD ? 256 : 512) / threads; }

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

// ---------------------------------------------------------------- the exact-width kernels

// V elements of T as one load: a 16-byte vector, or one element (V = 1, the unaligned route)
template <typename T, int V>
using RowBits = std::conditional_t<V * sizeof(T) == 16, uint4, T>;

template <typename T, int V>
__device__ __forceinline__ RowBits<T, V> load_bits(const T* __restrict__ p) {
  if constexpr (V * sizeof(T) == 16) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
    static_assert(V == 1, "a row of V channels is one 16-byte vector or one element");
    return *p;
  }
}

template <typename T, int V>
__device__ __forceinline__ RowBits<T, V> zero_bits() {
  if constexpr (V * sizeof(T) == 16) {
    return make_uint4(0, 0, 0, 0);
  } else {
    return mojo_from_float<T>(0.f);
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const RowBits<T, V>& bits, float (&f)[V]) {
  const T* t = reinterpret_cast<const T*>(&bits);
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = mojo_to_float(t[v]);
}

template <typename T, int V>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 u;
    T* t = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int v = 0; v < V; ++v) t[v] = mojo_from_float<T>(f[v]);
    __stcs(reinterpret_cast<uint4*>(p), u);
  } else {
    *p = mojo_from_float<T>(f[0]);
  }
}

// taps k[w] and bias of channels c..c+V-1
template <int W, int V>
__device__ __forceinline__ void load_exact_taps(const float* __restrict__ w, const float* __restrict__ bias, int c,
                                                float (&k)[W][V], float (&bv)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < W; ++i) k[i][v] = w[static_cast<int64_t>(c + v) * W + i];
    bv[v] = bias != nullptr ? bias[c + v] : 0.f;
  }
}

// z = b + sum_w stream[t + w] * k[w] in tap order: win holds stream rows t .. t+W-2, cur the newest
template <int W, int V>
__device__ __forceinline__ void exact_z(const float (&win)[W][V], const float (&cur)[V], const float (&k)[W][V],
                                        const float (&bv)[V], float (&z)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    z[v] = bv[v];
#pragma unroll
    for (int i = 0; i < W - 1; ++i) z[v] += win[i][v] * k[i][v];
    z[v] += cur[v] * k[W - 1][v];
  }
}

// the window's oldest row out, cur in at W-2 (win is sized W so that W = 1 compiles; its row W-1 is unused)
template <int W, int V>
__device__ __forceinline__ void push_row(float (&win)[W][V], const float (&cur)[V]) {
#pragma unroll
  for (int i = 0; i + 1 < W - 1; ++i) {
#pragma unroll
    for (int v = 0; v < V; ++v) win[i][v] = win[i + 1][v];
  }
  if constexpr (W > 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) win[W - 2][v] = cur[v];
  }
}

// R rows of one tensor from row `base` on, zero at and past row `stop`
template <typename T, int V, int R>
__device__ __forceinline__ void load_ring(RowBits<T, V> (&ring)[R], const T* __restrict__ p, int base, int stop,
                                          int D) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ring[r] = base + r < stop ? load_bits<T, V>(p + static_cast<int64_t>(base + r) * D) : zero_bits<T, V>();
  }
}

// P: the next R rows are loaded before the current R rows' math (2R loads of each tensor a thread in flight),
// else after it
template <typename T, int W, int V, int R, int NT, bool P>
__global__ void __launch_bounds__(NT, exact_min_blocks<false>(NT))
conv1d_fwd_exact_kernel(const T* __restrict__ x, const T* __restrict__ state, const float* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ out, int B, int Tn, int D, int chunk,
                        int act) {
  const int c = (blockIdx.x * NT + threadIdx.x) * V;
  if (c >= D) return;
  const int n_chunks = (Tn + chunk - 1) / chunk;
  float k[W][V], bv[V];
  load_exact_taps<W, V>(w, bias, c, k, bv);
  for (int q = blockIdx.y; q < B * n_chunks; q += gridDim.y) {
    const int b = q / n_chunks, t0 = (q % n_chunks) * chunk, t_end = min(t0 + chunk, Tn);
    const T* xs = x + static_cast<int64_t>(b) * Tn * D + c;
    const T* ss = state + static_cast<int64_t>(b) * (W - 1) * D + c;
    T* os = out + static_cast<int64_t>(b) * Tn * D + c;
    float win[W][V];  // stream rows t - (W-1) .. t - 1 before row t
#pragma unroll
    for (int i = 0; i < W - 1; ++i) stream_row<T, V>(xs, ss, t0 - (W - 1) + i, W, D, win[i]);
    RowBits<T, V> ring[R];
    load_ring<T, V, R>(ring, xs, t0, t_end, D);
    for (int base = t0; base < t_end; base += R) {
      RowBits<T, V> rows[R];
#pragma unroll
      for (int r = 0; r < R; ++r) rows[r] = ring[r];
      if constexpr (P) load_ring<T, V, R>(ring, xs, base + R, t_end, D);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float cur[V], z[V];
        unpack<T, V>(rows[r], cur);
        exact_z<W, V>(win, cur, k, bv, z);
        if (act) {
#pragma unroll
          for (int v = 0; v < V; ++v) z[v] *= sigmoid(z[v]);
        }
        if (base + r < t_end) store_row<T, V>(os + static_cast<int64_t>(base + r) * D, z);
        push_row<W, V>(win, cur);
      }
      if constexpr (!P) load_ring<T, V, R>(ring, xs, base + R, t_end, D);
    }
  }
}

template <typename T, int W, int V, int R, int NT, bool P>
__global__ void __launch_bounds__(NT, exact_min_blocks<true>(NT))
conv1d_bwd_exact_kernel(const T* __restrict__ x, const T* __restrict__ state, const float* __restrict__ w,
                        const float* __restrict__ bias, const T* __restrict__ g, T* __restrict__ dx,
                        float* __restrict__ part, int B, int Tn, int D, int chunk, int act) {
  const int c = (blockIdx.x * NT + threadIdx.x) * V;
  if (c >= D) return;
  const int slot = blockIdx.y, slots = gridDim.y;
  const int n_chunks = (Tn + chunk - 1) / chunk;
  float k[W][V], bv[V], dwr[W][V], db[V];
  load_exact_taps<W, V>(w, bias, c, k, bv);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) dwr[i][v] = 0.f;
  }
  for (int q = slot; q < B * n_chunks; q += slots) {
    const int b = q / n_chunks, t0 = (q % n_chunks) * chunk;
    const int t_own = min(t0 + chunk, Tn);  // rows [t0, t_own) get their dx, dw and db terms here
    const int t_last = t_own + W - 1;       // dz rows up to t_last - 1 feed those dx rows
    const int t_read = min(t_last, Tn);     // rows read: x and g past T are zero
    const int64_t seq = static_cast<int64_t>(b) * Tn * D + c;
    const T* xs = x + seq;
    const T* gs = g + seq;
    const T* ss = state + static_cast<int64_t>(b) * (W - 1) * D + c;
    T* dxs = dx + seq;
    float xw[W][V], dzw[W][V];  // before row tp: stream rows tp - (W-1) .. tp - 1 and their dz rows
#pragma unroll
    for (int i = 0; i < W - 1; ++i) {
      stream_row<T, V>(xs, ss, t0 - (W - 1) + i, W, D, xw[i]);
#pragma unroll
      for (int v = 0; v < V; ++v) dzw[i][v] = 0.f;
    }
    RowBits<T, V> xring[R], gring[R];
    load_ring<T, V, R>(xring, xs, t0, t_read, D);
    load_ring<T, V, R>(gring, gs, t0, t_read, D);
    for (int base = t0; base < t_last; base += R) {
      RowBits<T, V> xrows[R], grows[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        xrows[r] = xring[r];
        grows[r] = gring[r];
      }
      if constexpr (P) {
        load_ring<T, V, R>(xring, xs, base + R, t_read, D);
        load_ring<T, V, R>(gring, gs, base + R, t_read, D);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int tp = base + r;
        float cur[V], dz[V];
        unpack<T, V>(xrows[r], cur);
        unpack<T, V>(grows[r], dz);  // g; zero past T, so dz = 0 there
        if (act && tp < Tn) {
          float z[V];
          exact_z<W, V>(xw, cur, k, bv, z);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float s = sigmoid(z[v]);
            dz[v] = dz[v] * (s * (1.f + z[v] * (1.f - s)));
          }
        }
        if (tp < t_own) {  // dw[w] takes dz[tp] * stream[tp + w]: the window's row w, the newest for w = W-1
#pragma unroll
          for (int v = 0; v < V; ++v) {
#pragma unroll
            for (int i = 0; i < W - 1; ++i) dwr[i][v] += dz[v] * xw[i][v];
            dwr[W - 1][v] += dz[v] * cur[v];
            db[v] += dz[v];
          }
        }
        if (tp - (W - 1) >= t0 && tp < t_last) {  // dx[j] = sum_w dz[tp - w] * k[w], j = tp - (W-1)
          float d[V];
#pragma unroll
          for (int v = 0; v < V; ++v) {
            d[v] = 0.f;
            d[v] += dz[v] * k[0][v];
#pragma unroll
            for (int i = 1; i < W; ++i) d[v] += dzw[W - 1 - i][v] * k[i][v];
          }
          store_row<T, V>(dxs + static_cast<int64_t>(tp - (W - 1)) * D, d);
        }
        push_row<W, V>(xw, cur);
        push_row<W, V>(dzw, dz);
      }
      if constexpr (!P) {
        load_ring<T, V, R>(xring, xs, base + R, t_read, D);
        load_ring<T, V, R>(gring, gs, base + R, t_read, D);
      }
    }
  }
  // this slot's partial row: (W + 1, D), dw rows then db
  float* ps = part + static_cast<int64_t>(slot) * (W + 1) * D + c;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < W; ++i) ps[static_cast<int64_t>(i) * D + v] = dwr[i][v];
    ps[static_cast<int64_t>(W) * D + v] = db[v];
  }
}

// ---------------------------------------------------------------- the generic kernels (W 5-16)

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
                  const float* __restrict__ bias, T* __restrict__ out, int Tn, int D, int W, int chunk, int act) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= D) return;
  const int t0 = blockIdx.y * chunk, b = blockIdx.z;
  const T* xs = x + static_cast<int64_t>(b) * Tn * D + c;
  const T* ss = state + static_cast<int64_t>(b) * (W - 1) * D + c;
  T* os = out + static_cast<int64_t>(b) * Tn * D + c;
  float kr[MAXW][V], kl[MAXW][V], bv[V], xw[MAXW][V];
  load_taps<MAXW, V>(w, c, W, kr, kl);
#pragma unroll
  for (int v = 0; v < V; ++v) bv[v] = bias != nullptr ? bias[c + v] : 0.f;
  load_halo<T, MAXW, V>(xs, ss, t0, W, D, xw);
  const int t_end = min(t0 + chunk, Tn);
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
                  float* __restrict__ part, int B, int Tn, int D, int W, int chunk, int act) {
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= D) return;
  const int slot = blockIdx.y, slots = gridDim.y;
  const int n_chunks = (Tn + chunk - 1) / chunk;
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
    const int b = q / n_chunks, t0 = (q % n_chunks) * chunk;
    const int t_own = min(t0 + chunk, Tn);  // rows [t0, t_own) get their dx, dw and db terms here
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

// channels a generic thread owns: the window and the taps hold kMaxW x V floats
template <typename T, bool BWD>
constexpr int generic_vec() {
  constexpr int bytes = BWD ? 1 : 4;
  return bytes / static_cast<int>(sizeof(T)) > 0 ? bytes / static_cast<int>(sizeof(T)) : 1;
}

// ---------------------------------------------------------------- launches

struct ConvArgs {
  const void* x;
  const void* state;
  const float* w;
  const float* bias;
  int B, Tn, D, W, act, chunk, slots;
};

template <int W_, int V_, int R_, int NT_, bool P_>
struct ExactTag {
  static constexpr int W = W_, V = V_, R = R_, NT = NT_;
  static constexpr bool P = P_;
};

// fn(ExactTag<W, V, R, NT, P>{}) for the exact-width kernel of width W at (ring, threads, prefetch) = (kRing,
// kExactThreads, kPrefetch), or at another triple that split_sweep's conv1d mode times (bf16, 16-byte vectors,
// W = 4 only); false for a triple that is not instantiated
template <typename T, int V, typename Fn>
bool with_exact(int W, int ring, int threads, int prefetch, Fn&& fn) {
  if (ring == kRing && threads == kExactThreads && prefetch == kPrefetch) {
    switch (W) {
      case 1: fn(ExactTag<1, V, kRing, kExactThreads, kPrefetch>{}); return true;
      case 2: fn(ExactTag<2, V, kRing, kExactThreads, kPrefetch>{}); return true;
      case 3: fn(ExactTag<3, V, kRing, kExactThreads, kPrefetch>{}); return true;
      case 4: fn(ExactTag<4, V, kRing, kExactThreads, kPrefetch>{}); return true;
      default: return false;
    }
  }
  if constexpr (std::is_same_v<T, __nv_bfloat16> && V == 8) {
    if (W != 4) return false;
#define MOJO_CONV_SWEEP_CASE(R_, NT_, P_)                     \
  if (ring == R_ && threads == NT_ && prefetch == P_) {       \
    fn(ExactTag<4, V, R_, NT_, P_>{});                        \
    return true;                                              \
  }
    MOJO_CONV_SWEEP_CASE(4, 128, false) MOJO_CONV_SWEEP_CASE(8, 128, false) MOJO_CONV_SWEEP_CASE(2, 128, true)
    MOJO_CONV_SWEEP_CASE(4, 64, true) MOJO_CONV_SWEEP_CASE(4, 256, true)
#undef MOJO_CONV_SWEEP_CASE
  }
  return false;
}

template <typename T, typename Fn>
bool with_exact_vec(int vec, int W, int ring, int threads, int prefetch, Fn&& fn) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  return vec ? with_exact<T, kVec>(W, ring, threads, prefetch, fn)
             : with_exact<T, 1>(W, ring, threads, prefetch, fn);
}

template <typename T, typename Tag>
void launch_fwd_exact(const ConvArgs& a, void* out, cudaStream_t stream) {
  const dim3 grid((a.D + Tag::NT * Tag::V - 1) / (Tag::NT * Tag::V), a.slots);
  conv1d_fwd_exact_kernel<T, Tag::W, Tag::V, Tag::R, Tag::NT, Tag::P><<<grid, Tag::NT, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.state), a.w, a.bias, static_cast<T*>(out), a.B, a.Tn, a.D,
      a.chunk, a.act);
}

template <typename T, typename Tag>
void launch_bwd_exact(const ConvArgs& a, const void* g, void* dx, float* part, cudaStream_t stream) {
  const dim3 grid((a.D + Tag::NT * Tag::V - 1) / (Tag::NT * Tag::V), a.slots);
  conv1d_bwd_exact_kernel<T, Tag::W, Tag::V, Tag::R, Tag::NT, Tag::P><<<grid, Tag::NT, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.state), a.w, a.bias, static_cast<const T*>(g),
      static_cast<T*>(dx), part, a.B, a.Tn, a.D, a.chunk, a.act);
}

template <typename T, int V>
void launch_fwd_generic(const ConvArgs& a, void* out, cudaStream_t stream) {
  const dim3 grid((a.D + kThreads * V - 1) / (kThreads * V), (a.Tn + a.chunk - 1) / a.chunk, a.B);
  conv1d_fwd_kernel<T, kMaxW, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.state), a.w, a.bias, static_cast<T*>(out), a.Tn, a.D, a.W,
      a.chunk, a.act);
}

template <typename T, int V>
void launch_bwd_generic(const ConvArgs& a, const void* g, void* dx, float* part, cudaStream_t stream) {
  const dim3 grid((a.D + kThreads * V - 1) / (kThreads * V), a.slots);
  conv1d_bwd_kernel<T, kMaxW, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.state), a.w, a.bias, static_cast<const T*>(g),
      static_cast<T*>(dx), part, a.B, a.Tn, a.D, a.W, a.chunk, a.act);
}

bool valid(int B, int T, int D, int W, int chunk, int slots) {
  return B > 0 && T > 0 && D > 0 && W >= 1 && W <= kMaxW && chunk > 0 && slots > 0 && slots <= 65535;
}

}  // namespace

// x, out: (B, T, D) contiguous in `dtype`; state: (B, W-1, D) contiguous in
// `dtype` (the stream rows before x); w: (D, W) fp32; bias: (D,) fp32 or
// null. 1 <= W <= 16. `vec` = 1 when D is a multiple of 16 bytes' worth of
// elements and x, state, out are 16-byte aligned. `chunk`: time rows a
// chunk; `slots`: the exact-width kernels' blocks along time (each walks
// chunks slot, slot + slots, ...; the generic forward covers every chunk
// with a block); (ring, threads): the exact-width kernel's rows loaded ahead
// and threads a block, and whether it loads the next rows before the current
// rows' math (conv1d_vjp.RING, THREADS, PREFETCH; other triples for the
// sweep).
extern "C" int mojo_conv1d_fwd(const void* x, const void* state, const void* w, const void* bias, void* out, int B,
                               int T, int D, int W, int act, int vec, int chunk, int slots, int ring, int threads,
                               int prefetch, int dtype, void* stream) {
  if (!valid(B, T, D, W, chunk, slots)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvArgs a{x, state, static_cast<const float*>(w), static_cast<const float*>(bias), B, T, D, W, act, chunk,
                   slots};
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, Tp, {
    if (W <= 4) {
      if (with_exact_vec<Tp>(vec, W, ring, threads, prefetch,
                             [&](auto tag) { launch_fwd_exact<Tp, decltype(tag)>(a, out, s); })) {
        rc = static_cast<int>(cudaGetLastError());
      }
    } else {
      if (vec) {
        launch_fwd_generic<Tp, generic_vec<Tp, false>()>(a, out, s);
      } else {
        launch_fwd_generic<Tp, 1>(a, out, s);
      }
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  return rc;
}

// x, g, dx: (B, T, D) contiguous in `dtype`; state, w, bias, W, chunk, ring,
// threads and vec as for the forward (vec also covers g and dx); part:
// (slots, W + 1, D) fp32 scratch, one row a slot (the shape alone fixes the
// slots, so a call's bits repeat); dwb: (W + 1, D) fp32, dw's W rows then db.
extern "C" int mojo_conv1d_bwd(const void* x, const void* state, const void* w, const void* bias, const void* g,
                               void* dx, void* part, void* dwb, int B, int T, int D, int W, int act, int vec,
                               int chunk, int slots, int ring, int threads, int prefetch, int dtype, void* stream) {
  if (!valid(B, T, D, W, chunk, slots)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvArgs a{x, state, static_cast<const float*>(w), static_cast<const float*>(bias), B, T, D, W, act, chunk,
                   slots};
  float* pf = static_cast<float*>(part);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, Tp, {
    if (W <= 4) {
      if (with_exact_vec<Tp>(vec, W, ring, threads, prefetch,
                             [&](auto tag) { launch_bwd_exact<Tp, decltype(tag)>(a, g, dx, pf, s); })) {
        rc = static_cast<int>(cudaGetLastError());
      }
    } else {
      if (vec) {
        launch_bwd_generic<Tp, generic_vec<Tp, true>()>(a, g, dx, pf, s);
      } else {
        launch_bwd_generic<Tp, 1>(a, g, dx, pf, s);
      }
      rc = static_cast<int>(cudaGetLastError());
    }
  });
  if (rc != static_cast<int>(cudaSuccess)) return rc;
  const int cols = (W + 1) * D;
  mojo_column_sum_kernel<><<<(cols + kMojoSumCols - 1) / kMojoSumCols, kMojoSumCols * kMojoSumSlices, 0, s>>>(
      pf, static_cast<float*>(dwb), slots, cols);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread, blocks an SM, spill bytes and static shared bytes (common.cuh mojo_kernel_resources) of the
// kernel the forward (bwd = 0) or the backward entry point takes for the same W, vec, ring, threads and dtype
extern "C" int mojo_conv1d_resources(int W, int vec, int bwd, int ring, int threads, int prefetch, int dtype,
                                     int* out) {
  if (W < 1 || W > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, Tp, {
    if (W <= kExactMaxW) {
      with_exact_vec<Tp>(vec, W, ring, threads, prefetch, [&](auto tag) {
        using K = decltype(tag);
        rc = bwd ? mojo_kernel_resources(conv1d_bwd_exact_kernel<Tp, K::W, K::V, K::R, K::NT, K::P>, K::NT, 0, out)
                 : mojo_kernel_resources(conv1d_fwd_exact_kernel<Tp, K::W, K::V, K::R, K::NT, K::P>, K::NT, 0, out);
      });
    } else if (bwd) {
      rc = vec ? mojo_kernel_resources(conv1d_bwd_kernel<Tp, kMaxW, generic_vec<Tp, true>()>, kThreads, 0, out)
               : mojo_kernel_resources(conv1d_bwd_kernel<Tp, kMaxW, 1>, kThreads, 0, out);
    } else {
      rc = vec ? mojo_kernel_resources(conv1d_fwd_kernel<Tp, kMaxW, generic_vec<Tp, false>()>, kThreads, 0, out)
               : mojo_kernel_resources(conv1d_fwd_kernel<Tp, kMaxW, 1>, kThreads, 0, out);
    }
  });
  return rc;
}
