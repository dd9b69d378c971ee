// Shared pieces of the flash-attention kernels J (flash_swa.cu, for the JAX
// package's flash_vjp.py:462 flash_swa) and O (flash_diffusion.cu, for
// diffusion_vjp.py:289 flash_diffusion). A kernel keeps only how it finds
// its rows and keys and its keep-predicate; the tiling, staging, products
// and online softmax are here, so both kernels run the same arithmetic.
//
// Bound on the H100: operations (4 D per kept pair and query head in the
// forward, 6 D in dq, 8 D in dk/dv, against 989 TFLOP/s of bf16/fp16 tensor
// cores). Two routes, chosen by the input dtype in the C entry points:
//
// bf16 / fp16: tensor-core tiles (mma.sync.m16n8k16, fp32 accumulators).
//   A forward / dq block is 4 warps over 64 query rows, warp w owning rows
//   16 w .. 16 w + 15; a dk/dv block 4 warps over 64 keys, warp w owning
//   keys 16 w .. (at D 256, 8 warps: w and w + 4 share keys 16 (w % 4) ..
//   and each keeps half of dk's and dv's columns, since two 16 x 256 fp32
//   accumulators would take 256 registers a thread). Q, K, V and dO are
//   staged in shared memory in the working type by cp.async, rows at a
//   pitch of D + 8 elements so that the 8 rows one ldmatrix reads fall in 8
//   different bank groups; K/V (forward, dq) and Q/dO (dk/dv) tiles run in a
//   two-stage ring, tile j + 1 loading while tile j's products run. In an
//   accumulator fragment a lane owns rows lane / 4 (c[0], c[1]) and
//   lane / 4 + 8 (c[2], c[3]) at columns 2 (lane % 4) and + 1 of each n-tile
//   of 8, so the online softmax reduces a row over the lane's quad with two
//   shuffles, and P (or dS) turns into the A fragment of the next product in
//   registers, with no trip through shared memory. S = Q K^T and
//   dP = dO V^T take inputs exactly (bf16 x bf16 products, fp32 sums), but
//   P and dS are fp32: rounded once to bf16 they would miss the fp32 TPU
//   kernel by ~2e-3 relative (2-3x over chip_smoke.py's limits), so each is
//   split into hi = T(x) and lo = T(x - hi), two MMAs into one accumulator,
//   which keeps the products within ~1e-4 of fp32 for 1.5x the forward's
//   tensor work (the MMAs of PV, dS K, P^T dO and dS^T Q double).
//   Key tiles are 64 wide (32 at D 256, where the 16 x 256 output
//   accumulator takes 128 registers); dk/dv takes 32 query rows a tile, its
//   S^T and dP^T then 32 registers beside dk's and dv's accumulators.
//   The forward holds Q's fragments in registers for the whole key loop
//   (D <= 128; at D 256 it reads them from shared memory per tile). A tile
//   that every row keeps whole skips the per-cell predicate. Left for
//   later: wgmma over 64-row warpgroup tiles with TMA-fed K/V rings and
//   warp specialisation (mma.sync does not reach the tensor cores' full
//   rate on Hopper), and more rows a warp to reuse each K/V fragment.
// fp32: scalar FMAs (the tensor cores have no exact fp32 product, and TF32
//   would miss the fp32 limits by orders of magnitude). A block is 128
//   threads over 64 query rows: thread (rg, cg) = (tid / 8, tid % 8) owns
//   rows rg * 4 .. rg * 4 + 3, score columns cg + 8 c of a 32-key tile and
//   output columns cg + 8 c of D. A dk/dv block owns KR keys (dkv_rows)
//   the same way, TR = KR / 16 per thread, against 32-query tiles. Staged
//   rows are fp32 with a padded stride of D + 1; P and dS tiles have a
//   padded stride of 33.
#pragma once

#include "common.cuh"

namespace mojo_flash {

constexpr int kThreads = 128;
constexpr int kRows = 64;   // query rows of a forward / dq block
constexpr int kTR = 4;      // rows per thread there
constexpr int kCG = 8;      // threads sharing a row group (adjacent lanes)
constexpr int kBK = 32;     // keys per tile (forward / dq); query rows per tile (dk/dv)
constexpr int kTC = kBK / kCG;  // score columns per thread
constexpr int kSS = kBK + 1;    // padded row stride of P / dS
constexpr float kEmptyLse = 1e30f;

static_assert(kRows == kTR * kThreads / kCG, "thread tiling must cover the rows");

// keys of a dk/dv block: two (KR x D/8) accumulators a thread stay in registers
template <int D>
__host__ __device__ constexpr int dkv_rows() { return D >= 256 ? 32 : 64; }

template <int D>
constexpr int rows_smem_floats(int big_rows, int big_tiles, int small_rows, int small_tiles) {
  return big_tiles * big_rows * (D + 1) + small_tiles * small_rows * (D + 1) + kRows * kSS;
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// Stage rows [r0, r0 + n) into s (n x (D + 1) floats, times mul); row r of x
// starts `stride` elements after row r - 1. Zero past `limit` rows.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* s, const T* __restrict__ x, int r0, int n, int limit,
                                           int64_t stride, float mul) {
  constexpr int QS = D + 1;
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  for (int i = threadIdx.x; i < n * (D / VE); i += kThreads) {
    const int r = i % n;
    const int d0 = (i / n) * VE;
    float f[VE];
    if (r0 + r < limit) {
      mojo_load_row<T, VE>(x + static_cast<int64_t>(r0 + r) * stride + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VE; ++e) s[r * QS + d0 + e] = f[e] * mul;
  }
}

// s[i][c] += A[rg * TR + i] . B[cg + kCG * c] over D (staged rows)
template <int D, int TR>
__device__ __forceinline__ void tile_scores(float (&s)[TR][kTC], const float* a, const float* b, int rg, int cg) {
  constexpr int QS = D + 1;
  for (int d = 0; d < D; ++d) {
    float av[TR], bv[kTC];
#pragma unroll
    for (int i = 0; i < TR; ++i) av[i] = a[(rg * TR + i) * QS + d];
#pragma unroll
    for (int c = 0; c < kTC; ++c) bv[c] = b[(cg + kCG * c) * QS + d];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) s[i][c] += av[i] * bv[c];
  }
}

// The backward's two products in one sweep over D: s += A0 B0^T, dp += A1 B1^T
template <int D, int TR>
__device__ __forceinline__ void tile_scores2(float (&s)[TR][kTC], float (&dp)[TR][kTC], const float* a0,
                                             const float* b0, const float* a1, const float* b1, int rg, int cg) {
  constexpr int QS = D + 1;
  for (int d = 0; d < D; ++d) {
    float a0v[TR], a1v[TR], b0v[kTC], b1v[kTC];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      a0v[i] = a0[(rg * TR + i) * QS + d];
      a1v[i] = a1[(rg * TR + i) * QS + d];
    }
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      b0v[c] = b0[(cg + kCG * c) * QS + d];
      b1v[c] = b1[(cg + kCG * c) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int c = 0; c < kTC; ++c) {
        s[i][c] += a0v[i] * b0v[c];
        dp[i][c] += a1v[i] * b1v[c];
      }
  }
}

// acc[i][c] += sum over j < kBK of P[rg * TR + i][j] * X[j][cg + kCG * c]
// (P with row stride kSS, X staged rows)
template <int D, int TR>
__device__ __forceinline__ void tile_accumulate(float (&acc)[TR][D / kCG], const float* p, const float* x, int rg,
                                                int cg) {
  constexpr int QS = D + 1;
  for (int j = 0; j < kBK; ++j) {
    float pv[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) pv[i] = p[(rg * TR + i) * kSS + j];
#pragma unroll
    for (int c = 0; c < D / kCG; ++c) {
      const float xv = x[j * QS + cg + kCG * c];
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[i][c] += pv[i] * xv;
    }
  }
}

// This thread's cells of s into p (row stride kSS)
template <int TR>
__device__ __forceinline__ void store_cells(float* p, const float (&s)[TR][kTC], int rg, int cg) {
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < kTC; ++c) p[(rg * TR + i) * kSS + cg + kCG * c] = s[i][c];
}

// One online-softmax step of this thread's kTR rows over a key tile whose
// masked scores are -inf: new running max m and sum l, acc rescaled, and the
// tile's probabilities written to p_s for the PV product.
template <int D>
__device__ __forceinline__ void online_softmax(const float (&s)[kTR][kTC], float (&m)[kTR], float (&l)[kTR],
                                               float (&acc)[kTR][D / kCG], float* p_s, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kTC; ++c) mx = fmaxf(mx, s[i][c]);
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const float p = m_new == -INFINITY ? 0.f : expf(s[i][c] - m_new);
      p_s[(rg * kTR + i) * kSS + cg + kCG * c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < kCG; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < D / kCG; ++c) acc[i][c] *= alpha;
  }
}


// -- tensor-core tiles (bf16 / fp16) ------------------------------------------------

constexpr int kMmaWarps = 4;     // forward / dq block: 4 x 16 query rows
constexpr int kMmaQ = 32;        // query rows of a dk/dv tile
constexpr int kMmaKeys = 64;     // keys of a dk/dv block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys of a forward / dq tile
template <int D>
__host__ __device__ constexpr int mma_keys() { return D >= 256 ? 32 : 64; }
// warps of a dk/dv block (at D 256 a pair of warps splits dk's and dv's columns)
template <int D>
__host__ __device__ constexpr int dkv_warps() { return D >= 256 ? 8 : 4; }

extern __shared__ __align__(16) unsigned char mojo_mma_smem[];

// Stage ROWS rows of D 16-bit elements into s (pitch D + 8) by cp.async.
// src(r) is row r's first element, or nullptr for a zero-filled row (then
// `base`, a valid address, stands in and is not read). Only the first
// `chunks` 16-byte chunks of a row are read (a row narrower than D); the
// rest are zero-filled.
template <int D, int ROWS, int NTH, typename T, class Src>
__device__ __forceinline__ void cp_rows(T* s, const T* base, Src&& src, int chunks = D / 8) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTH) {
    const int r = i / CH, c = i % CH;
    const T* p = src(r);
    const bool ok = p != nullptr && c < chunks;
    cp_async16(s + r * (D + 8) + c * 8, ok ? p + c * 8 : base, ok);
  }
}

// The A fragment (16 x 16) at rows r0.., columns c0.. of a row-major tile of pitch P.
template <int P, typename T>
__device__ __forceinline__ void frag_a(unsigned (&a)[4], const T* s, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, s + (r0 + (lane & 15)) * P + c0 + (lane >> 4) * 8);
}

// B fragments of the n-tiles n0 and n0 + 8 at k-chunk k0 (16 deep) of a
// tile stored [n][k] (the rows of B^T): b[0..1] the first, b[2..3] the second.
template <int P, typename T>
__device__ __forceinline__ void frag_b_nk(unsigned (&b)[4], const T* s, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * P + k0 + ((lane >> 3) & 1) * 8);
}

// The same from a tile stored [k][n], transposed by ldmatrix.
template <int P, typename T>
__device__ __forceinline__ void frag_b_kn(unsigned (&b)[4], const T* s, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P + n0 + (lane >> 4) * 8);
}

template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V pack(float x, float y) { return __floats2bfloat162_rn(x, y); }
  static __device__ __forceinline__ float2 unpack(V v) { return __bfloat1622float2(v); }
};
template <>
struct Pair<__half> {
  using V = __half2;
  static __device__ __forceinline__ V pack(float x, float y) { return __floats2half2_rn(x, y); }
  static __device__ __forceinline__ float2 unpack(V v) { return __half22float2(v); }
};

template <typename V>
__device__ __forceinline__ unsigned bits32(V v) { return *reinterpret_cast<const unsigned*>(&v); }

// x rounded (half away from zero) to the 2 p significant bits that hi + lo
// of a p-bit type carry exactly: 16 for bf16, 22 for fp16. So the split
// loses nothing more, and a p within that grid of 1 (a row that keeps one
// key, its exp(s - lse) off by fp32 rounding) is exactly 1, as in the fp32
// reference, instead of breaking its sums' bf16 rounding ties at random.
template <typename T>
__device__ __forceinline__ float round_split(float x) {
  constexpr int kDrop = std::is_same_v<T, __nv_bfloat16> ? 8 : 2;  // 23 fraction bits less (2 p - 1)
  return __uint_as_float((__float_as_uint(x) + (1u << (kDrop - 1))) & ~((1u << kDrop) - 1u));
}

// (x, y) on round_split's grid as hi = T(x) packed x low, and lo = T(x - hi):
// hi + lo is that value exactly (in fp16 while lo is a normal number,
// |x| >= 2^-3; below, lo's subnormals hold it to 2^-24).
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  x = round_split<T>(x);
  y = round_split<T>(y);
  const typename Pair<T>::V h = Pair<T>::pack(x, y);
  const float2 f = Pair<T>::unpack(h);
  hi = bits32(h);
  lo = bits32(Pair<T>::pack(x - f.x, y - f.y));
}

// Store (x, y) rounded to T at p (4-byte aligned).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float x, float y) {
  *reinterpret_cast<typename Pair<T>::V*>(p) = Pair<T>::pack(x, y);
}

// c0 (n-tile n) and c1 (n-tile n + 1) += a times b's two n-tiles
template <typename T>
__device__ __forceinline__ void mma_pair(float (&c0)[4], float (&c1)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[4]) {
  const unsigned b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
  mma_16816<T>(c0, a, b0);
  mma_16816<T>(c1, a, b1);
}

// c (16 x 8 NT) += A B^T over K: A's k-chunk kc from fa(kc, a), B^T the
// rows 0 .. 8 NT - 1 of the [n][k] tile bs.
template <typename T, int P, int K, int NT, class FA>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], FA&& fa, const T* bs) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    unsigned a[4];
    fa(kc, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      frag_b_nk<P>(b, bs, np * 16, kc * 16);
      mma_pair<T>(c[2 * np], c[2 * np + 1], a, b);
    }
  }
}

// c (16 x 8 NT) += X V over K: X (16 x K) is fp32 accumulator fragments
// x[K / 8], each A fragment split into hi + lo (two MMAs); V the rows
// 0 .. K - 1, columns n0 .. n0 + 8 NT - 1 of the [k][n] tile vs.
template <typename T, int P, int K, int NT>
__device__ __forceinline__ void mma_xv_split(float (&c)[NT][4], const float (&x)[K / 8][4], const T* vs, int n0) {
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    unsigned hi[4], lo[4];
    split_pair<T>(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0]);
    split_pair<T>(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1]);
    split_pair<T>(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2]);
    split_pair<T>(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned b[4];
      frag_b_kn<P>(b, vs, kc * 16, n0 + np * 16);
      mma_pair<T>(c[2 * np], c[2 * np + 1], hi, b);
      mma_pair<T>(c[2 * np], c[2 * np + 1], lo, b);
    }
  }
}

// c += X V as mma_xv_split, but each pair of column tiles sums this call's
// share from zero in the tensor cores and adds it to c in fp32 (round to
// nearest). dk and dv walk every query tile of a kv head's group into one
// accumulator, hundreds of calls: added straight into it, each mma.sync's
// truncating accumulate biases the long sum. fp16's 11-bit output shows
// it (on an H100, dk 1.4e-4 off the fp32 plain version, relative, at the
// training shape; 1.7e-4 at 65 heads x 200 queries), bf16's 8 bits hide
// it, and the fp32 adds cost ~19% of dk/dv's time at the training shape:
// dkv_tile takes this for fp16 only.
template <typename T, int P, int K, int NT>
__device__ __forceinline__ void mma_xv_split_add(float (&c)[NT][4], const float (&x)[K / 8][4], const T* vs,
                                                 int n0) {
  unsigned hi[K / 16][4], lo[K / 16][4];
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    split_pair<T>(x[2 * kc][0], x[2 * kc][1], hi[kc][0], lo[kc][0]);
    split_pair<T>(x[2 * kc][2], x[2 * kc][3], hi[kc][1], lo[kc][1]);
    split_pair<T>(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[kc][2], lo[kc][2]);
    split_pair<T>(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[kc][3], lo[kc][3]);
  }
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    float t[2][4] = {};
#pragma unroll
    for (int kc = 0; kc < K / 16; ++kc) {
      unsigned b[4];
      frag_b_kn<P>(b, vs, kc * 16, n0 + np * 16);
      mma_pair<T>(t[0], t[1], hi[kc], b);
      mma_pair<T>(t[0], t[1], lo[kc], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      c[2 * np][e] += t[0][e];
      c[2 * np + 1][e] += t[1][e];
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_frags(float (&c)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
}

// A warp's 16 forward rows: the output accumulator, and for the lane's two
// rows (h = 0: lane / 4, h = 1: lane / 4 + 8) the running max of the
// scores in log2 units and the lane's partial sum of p.
template <typename T, int D>
struct FwdRows {
  float acc[D / 8][4];
  float m[2], l[2];

  __device__ __forceinline__ void init() {
    zero_frags(acc);
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // One key tile (BK keys, K and V rows of ks, vs): S = Q K^T (Q's k-chunk
  // from fq), then step().
  template <int BK, class FQ, class Keep>
  __device__ __forceinline__ void tile(FQ&& fq, const T* ks, const T* vs, float scale_log2, bool full, Keep&& keep) {
    float s[BK / 8][4];
    zero_frags(s);
    mma_abt<T, D + 8, D, BK / 8>(s, fq, ks);
    this->template step<BK>(s, vs, scale_log2, full, keep);
  }

  // The tile's raw scores s (16 x BK fp32 fragments) scaled to log2 units,
  // -inf where keep(h, column) is false unless the tile is full, an
  // online-softmax step, O += P V with P split (V the rows of vs).
  template <int BK, class Keep>
  __device__ __forceinline__ void step(float (&s)[BK / 8][4], const T* vs, float scale_log2, bool full,
                                       Keep&& keep) {
    constexpr int P = D + 8, NT = BK / 8;
    const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (!full && !keep(e >> 1, 8 * n + cq + (e & 1))) s[n][e] = -INFINITY;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // no kept key yet: p = exp2(-inf) = 0 and nothing to rescale
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[h] - base);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[n][e] = exp2f(s[n][e] - base);
          sum += s[n][e];
        }
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        acc[d][2 * h] *= alpha;
        acc[d][2 * h + 1] *= alpha;
      }
    }
    mma_xv_split<T, P, BK, D / 8>(acc, s, vs, 0);
  }

  // After the key loop: 1 / l (0 for a row that kept no key) and lse, the
  // quad's partial sums added in one order on every lane.
  __device__ __forceinline__ void finish(float (&inv)[2], float (&lse)[2], bool (&seen)[2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      seen[h] = t > 0.f;
      inv[h] = seen[h] ? 1.f / t : 0.f;
      lse[h] = seen[h] ? m[h] * kLn2 + logf(t) : kEmptyLse;
    }
  }
};

// dq of a warp's 16 rows over one key tile: S = Q K^T, dP = dO V^T (Q's
// and dO's k-chunks from fq, fdo), P = exp(S scale - lse) on the kept
// cells (lse2 = lse log2(e) of the lane's two rows), dS = P (dP - delta),
// dQ += dS K with dS split.
template <typename T, int D, int BK, class FQ, class FDO, class Keep>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], FQ&& fq, FDO&& fdo, const T* ks, const T* vs,
                                        const float (&lse2)[2], const float (&delta)[2], float scale_log2, bool full,
                                        Keep&& keep) {
  constexpr int P = D + 8, NT = BK / 8;
  float s[NT][4], dp[NT][4];
  zero_frags(s);
  zero_frags(dp);
  mma_abt<T, P, D, NT>(s, fq, ks);
  mma_abt<T, P, D, NT>(dp, fdo, vs);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool kept = full || keep(h, 8 * n + cq + (e & 1));
      // a masked cell's ds is 0 whatever its row's delta (NaN where an empty row's o is)
      s[n][e] = kept ? exp2f(fmaf(s[n][e], scale_log2, -lse2[h])) * (dp[n][e] - delta[h]) : 0.f;
    }
  mma_xv_split<T, P, BK, D / 8>(acc, s, ks, 0);
}

// dk and dv of a warp's 16 keys (rows kr0.. of ks, vs) against a tile of
// kMmaQ query rows (qs, dos; lse2 = lse log2(e) and delta by query row):
// S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T scale - lse) on the kept cells
// (keep(h, query row)), dS^T = P^T (dP^T - delta); dV += P^T dO and
// dK += dS^T Q on D's columns d0 .. d0 + DH - 1, P^T and dS^T split; in
// fp16 each tile's share added in fp32 (mma_xv_split_add).
template <typename T, int D, int DH, class Keep>
__device__ __forceinline__ void dkv_tile(float (&dk)[DH / 8][4], float (&dv)[DH / 8][4], const T* ks, const T* vs,
                                         int kr0, const T* qs, const T* dos, const float* lse2, const float* delta,
                                         int d0, float scale_log2, bool full, Keep&& keep) {
  constexpr int P = D + 8, NT = kMmaQ / 8;
  float s[NT][4], dp[NT][4];
  zero_frags(s);
  zero_frags(dp);
  mma_abt<T, P, D, NT>(s, [&](int kc, unsigned (&a)[4]) { frag_a<P>(a, ks, kr0, 16 * kc); }, qs);
  mma_abt<T, P, D, NT>(dp, [&](int kc, unsigned (&a)[4]) { frag_a<P>(a, vs, kr0, 16 * kc); }, dos);
  const int cq = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + cq + (e & 1);
      const bool kept = full || keep(e >> 1, c);
      const float p = kept ? exp2f(fmaf(s[n][e], scale_log2, -lse2[c])) : 0.f;
      s[n][e] = p;
      dp[n][e] = kept ? p * (dp[n][e] - delta[c]) : 0.f;
    }
  if constexpr (std::is_same_v<T, __half>) {
    mma_xv_split_add<T, P, kMmaQ, DH / 8>(dv, s, dos, d0);
    mma_xv_split_add<T, P, kMmaQ, DH / 8>(dk, dp, qs, d0);
  } else {
    mma_xv_split<T, P, kMmaQ, DH / 8>(dv, s, dos, d0);
    mma_xv_split<T, P, kMmaQ, DH / 8>(dk, dp, qs, d0);
  }
}

}  // namespace mojo_flash

// Run BODY with T bound to the dtype and D to the head dim (64, 128, 256);
// others fail. MOJO_FLASH_DISPATCH_PADDED binds D to the next of those at
// or above hd instead (hd a multiple of 16 up to 256).
#define MOJO_FLASH_DISPATCH(dtype, hd, ...)                            \
  MOJO_DISPATCH_DTYPE(dtype, T, {                                      \
    if (hd == 64) {                                                    \
      constexpr int D = 64;                                            \
      __VA_ARGS__;                                                     \
    } else if (hd == 128) {                                            \
      constexpr int D = 128;                                           \
      __VA_ARGS__;                                                     \
    } else if (hd == 256) {                                            \
      constexpr int D = 256;                                           \
      __VA_ARGS__;                                                     \
    } else {                                                           \
      return static_cast<int>(cudaErrorInvalidValue);                  \
    }                                                                  \
  })

#define MOJO_FLASH_DISPATCH_PADDED(dtype, hd, ...)                                          \
  MOJO_FLASH_DISPATCH(dtype, ((hd) <= 64 ? 64 : (hd) <= 128 ? 128 : (hd) <= 256 ? 256 : 0), __VA_ARGS__)
