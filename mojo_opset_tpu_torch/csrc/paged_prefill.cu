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
// Bound on the H100: operations (4 * D per visible query-key pair and
// query head; K/V tiles are re-read once per query tile). One block per
// (query tile, sequence, kv head). The tile holds 64 rows = (64 / group)
// tokens times the group's query heads (a ragged 60 rows at group 10), so
// each K/V tile serves every head of the group. Partial tiles, missing
// tokens, keys past the causal bound and table entries < 0 are masked
// (such entries are never read): blocks run in no order, so unlike the TPU
// kernel's clamped last tile (:80-83) no tile overlaps another. Two routes,
// by dtype:
//
// bf16 / fp16: the tensor-core tiles of flash_tiles.cuh, as kernel J's
//   forward (flash_swa.cu flash_swa_fwd_mma): 4 warps x 16 rows,
//   mma.sync.m16n8k16 with fp32 sums, 64-key tiles (32 at D 256) in a
//   two-stage cp.async ring, the softmax scale applied to the fp32 S, P
//   split into hi + lo. What is D's own: a key row is found through the
//   block table (cp_rows' source callback reads a per-key offset that
//   threads 0 .. BK - 1 work out two tiles ahead into a ring of three
//   slots, so a tile's copies never wait on its table loads; any block size
//   and layout, one row at a time), and the keep-predicate (position <=
//   the row's, inside the sequence, on a valid page). A tile below every
//   row's diagonal whose keys are all on valid pages skips the predicate.
//   The grid is one dimension, kv head fastest, then sequence, then the
//   query tile counted from the last: the causal tiles that walk the most
//   keys start first.
// int8 pages (kernel D', the C8 cache; replaces the scale folding of
//   backends/pallas/operators/attention.py:271-318): K/V are int8 with two
//   (Hkv, D) fp32 scale rows. Their rows land by cp.async in an int8 ring
//   and one pass converts a tile to T in shared memory (|v| <= 128 is
//   exact in bf16 and fp16). The key scale runs along D, the contraction,
//   so it is folded into Q in fp32 and Q * key_scale is rounded to T once:
//   that moves S by ~2^-9 of its size, as the plain version's rounding of P
//   to T moves its output, and stays inside chip_smoke.py's limits (PERF.md
//   section 6, PR 13); hi + lo, as P takes, would double the QK product.
//   The value scale multiplies the normalized output.
// fp32: scalar FMAs (no exact fp32 tensor-core product): each thread owns
//   4 rows x (32/8) score columns and 4 rows x (D/8) output columns of a
//   32-key tile staged in fp32, the key scale on the staged fp32 query.
// Groups over 64 query heads a kv head (71/1 MQA) go in chunks of at most
// 64 heads (gsize, from the caller: ceil(group / ceil(group / 64))), one
// more grid dimension, as kernel C's chunks of 16; a tile holds
// 64 / gsize tokens of its chunk's heads. Any head_dim hd that is a
// multiple of 16 up to 256 runs at the next instantiated width D: the
// staged Q and K/V rows are zero past hd (those chunks are zero-filled,
// not read), and columns past hd are never stored.
#include <type_traits>

#include "flash_tiles.cuh"

namespace {

using namespace mojo_flash;

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
paged_prefill_fma(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc,
                     const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                     const int* __restrict__ cu_q, const int* __restrict__ cu_kv,
                     const int* __restrict__ block_tables, T* __restrict__ out, int hq, int hkv, int hd,
                     int gsize, int chunks, int block_size, int max_blocks, int page_stride, int tok_stride,
                     int head_stride, float scale, int abab) {
  constexpr int QS = D + 1;       // padded row stride of Q, K, V (bank spread)
  constexpr int DC = D / kPreCG;  // output columns per thread
  constexpr bool kInt8 = std::is_same_v<TC, int8_t>;
  constexpr int VE = 16 / static_cast<int>(sizeof(TC));  // cache elements per 16-byte load
  static_assert(kPreBK == 32, "staging maps the tile's keys onto the 32 lanes");

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * gsize;  // the chunk's first head of the group
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int gn = min(gsize, group - g0);  // heads of this chunk
  const int tokens_per_tile = kPreRows / gsize;
  const int q_start = cu_q[b];
  const int q_len = cu_q[b + 1] - q_start;
  const int kv_len = cu_kv != nullptr ? cu_kv[b + 1] - cu_kv[b] : q_len;
  const int tok0 = tile * tokens_per_tile;  // first token of the tile, within the sequence
  if (tok0 >= q_len) return;                // block-uniform
  const int n_rows = min(tokens_per_tile, q_len - tok0) * gn;
  const int abs0 = kv_len - q_len + tok0;   // absolute position of the tile's first token
  const int kv_end = min(kv_len, abs0 + n_rows / gn);  // keys any row of the tile sees

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
    if (r < n_rows && d < hd) {
      const int g = g0 + r % gn;
      const int h = abab ? g * hkv + kvh : kvh * group + g;
      val = mojo_to_float(q[(static_cast<int64_t>(q_start + tok0 + r / gn) * hq + h) * hd + d]) * scale;
      if constexpr (kInt8) val *= k_scale[kvh * hd + d];
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
    row_abs[i] = r < n_rows ? abs0 + r / gn : -1;  // -1: no key is visible
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
      if (off >= 0 && d0 < hd) {
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
      const int g = g0 + r % gn;
      const int h = abab ? g * hkv + kvh : kvh * group + g;
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      T* o = out + (static_cast<int64_t>(q_start + tok0 + r / gn) * hq + h) * hd;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = cg + kPreCG * c;
        if (col >= hd) continue;
        float val = acc[i][c] * inv;
        if constexpr (kInt8) val *= v_scale[kvh * hd + col];
        o[col] = mojo_from_float<T>(val);
      }
    }
  }
}

// -- bf16 / fp16: tensor-core tiles ------------------------------------------------

struct PrefillArgs {
  const int* cu_q;
  const int* cu_kv;  // null: kv_len = q_len
  const int* block_tables;
  const float* k_scale;  // int8 pages: (hkv, hd)
  const float* v_scale;
  int B, q_tiles, hq, hkv, hd, gsize, chunks, block_size, max_blocks, page_stride, tok_stride, head_stride;
  float scale;
  int abab;
};

// Shared memory of a block, in elements of T then bytes. bf16/fp16 pages:
// the K/V ring of two stages (K then V, BK rows each), Q staged in stage 1
// and held in registers at D <= 128, in rows of its own at D 256. int8
// pages: Q * key_scale's rows at D 256 (at D <= 128 it is staged in the T
// stage and held in registers), one K/V stage in T, then the int8 ring of
// two stages.
template <typename T, typename TC, int D>
struct PreMma {
  static constexpr int BK = mma_keys<D>(), P = D + 8, NTH = kMmaWarps * 32;
  static constexpr bool kInt8 = std::is_same_v<TC, int8_t>;
  static constexpr bool kQRegs = D <= 128;  // Q's fragments in registers for the whole key loop
  // int8 pages: Q's rows (none at D <= 128, where Q is staged in the T stage), then the T stage
  static constexpr int kQElems = kQRegs ? 0 : kRows * P;
  static constexpr int kTElems = kInt8 ? kQElems + 2 * BK * P : (kQRegs ? 4 * BK * P : (4 * BK + kRows) * P);
  static constexpr int kBytes = kTElems * static_cast<int>(sizeof(T)) + (kInt8 ? 2 * 2 * BK * D : 0);
  static constexpr int kMinBlocks = D <= 128 ? 3 : 1;
};

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kMmaWarps * 32, (PreMma<T, TC, D>::kMinBlocks))
paged_prefill_mma(const T* __restrict__ q, const TC* __restrict__ kc, const TC* __restrict__ vc, T* __restrict__ out,
                  PrefillArgs a) {
  using C = PreMma<T, TC, D>;
  constexpr int BK = C::BK, P = C::P, NTH = C::NTH;
  constexpr bool kInt8 = C::kInt8, kQRegs = C::kQRegs;
  // blockIdx.x = (query tile counted from the last, sequence, kv head, chunk of its group), chunk fastest
  int x = blockIdx.x;
  const int g0 = (x % a.chunks) * a.gsize;  // the chunk's first head of the group
  x /= a.chunks;
  const int kvh = x % a.hkv;
  x /= a.hkv;
  const int b = x % a.B;
  const int tile = a.q_tiles - 1 - x / a.B;
  const int group = a.hq / a.hkv;
  const int gn = min(a.gsize, group - g0);  // heads of this chunk
  const int tpt = kRows / a.gsize;
  const int q_start = a.cu_q[b];
  const int q_len = a.cu_q[b + 1] - q_start;
  const int kv_len = a.cu_kv != nullptr ? a.cu_kv[b + 1] - a.cu_kv[b] : q_len;
  const int tok0 = tile * tpt;  // first token of the tile, within the sequence
  if (tok0 >= q_len) return;     // block-uniform
  const int n_tok = min(tpt, q_len - tok0);
  const int n_rows = n_tok * gn;
  const int abs0 = kv_len - q_len + tok0;               // absolute position of the tile's first token
  const int kv_end = max(0, min(kv_len, abs0 + n_tok));  // keys any row of the tile sees
  const int n_tiles = (kv_end + BK - 1) / BK;

  T* ts = reinterpret_cast<T*>(mojo_mma_smem);
  int8_t* ring8 = reinterpret_cast<int8_t*>(ts + C::kTElems);  // int8 pages: stage st, K then V, at st 2 BK D
  // per-key element offsets of a tile's K/V rows (-1: masked, not read), two tiles ahead in three slots, and
  // whether each 32 keys of the slot are all on valid pages
  __shared__ int64_t key_off[3][BK];
  __shared__ int slot_ok[3][BK / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* table = a.block_tables + static_cast<int64_t>(b) * a.max_blocks;
  const int64_t head_off = static_cast<int64_t>(kvh) * a.head_stride;

  auto row_of = [&](int r) -> int64_t {  // (token, head) row r of the tile as a row of q and out
    const int g = g0 + r % gn;
    const int h = a.abab ? g * a.hkv + kvh : kvh * group + g;
    return static_cast<int64_t>(q_start + tok0 + r / gn) * a.hq + h;
  };
  auto locate = [&](int j) {  // key tile j's offsets into slot j % 3
    if (tid < BK) {
      const int pos = j * BK + tid;
      const int lb = pos / a.block_size;
      const int page = pos < kv_end && lb < a.max_blocks ? table[lb] : -1;
      const int64_t off = page < 0 ? -1
                                   : static_cast<int64_t>(page) * a.page_stride +
                                         static_cast<int64_t>(pos % a.block_size) * a.tok_stride + head_off;
      key_off[j % 3][tid] = off;
      const bool ok = __all_sync(0xffffffffu, off >= 0);
      if (lane == 0) slot_ok[j % 3][tid / 32] = ok;
    }
  };
  auto load_kv = [&](int j, int st) {  // key tile j into ring stage st
    const int64_t* off = key_off[j % 3];
    if constexpr (kInt8) {
      constexpr int CH = D / 16;  // 16-byte chunks of an int8 row
      int8_t* r8 = ring8 + st * 2 * BK * D;
      for (int i = tid; i < 2 * BK * CH; i += NTH) {
        const int rr = i / CH, c = i % CH, r = rr % BK;  // rows 0 .. BK - 1: K, BK .. 2 BK - 1: V
        const TC* src = rr < BK ? kc : vc;
        const bool ok = off[r] >= 0 && c < a.hd / 16;
        cp_async16(r8 + rr * D + c * 16, ok ? src + off[r] + c * 16 : src, ok);
      }
    } else {
      T* ks = ts + st * 2 * BK * P;
      cp_rows<D, BK, NTH>(ks, kc, [&](int r) -> const T* { return off[r] >= 0 ? kc + off[r] : nullptr; }, a.hd / 8);
      cp_rows<D, BK, NTH>(ks + BK * P, vc, [&](int r) -> const T* { return off[r] >= 0 ? vc + off[r] : nullptr; },
                          a.hd / 8);
    }
  };

  if (n_tiles > 0) locate(0);
  if (n_tiles > 1) locate(1);
  __syncthreads();
  // Q: bf16/fp16 pages in ring stage 1 (D <= 128) or its own rows; int8 pages in the T stage or its own rows
  T* kv_t = ts + C::kQElems;  // int8 pages: the converted K rows, V BK P after
  T* q_s = kInt8 ? (kQRegs ? kv_t : ts) : ts + (kQRegs ? 2 * BK * P : 4 * BK * P);
  if constexpr (kInt8) {
    for (int i = tid; i < kRows * (D / 2); i += NTH) {
      const int r = i / (D / 2), d = 2 * (i % (D / 2));
      float x0 = 0.f, x1 = 0.f;
      if (r < n_rows && d < a.hd) {
        const T* src = q + row_of(r) * a.hd + d;
        x0 = mojo_to_float(src[0]) * a.k_scale[kvh * a.hd + d];
        x1 = mojo_to_float(src[1]) * a.k_scale[kvh * a.hd + d + 1];
      }
      store_pair(q_s + r * P + d, x0, x1);
    }
  } else {
    cp_rows<D, kRows, NTH>(q_s, q, [&](int r) -> const T* { return r < n_rows ? q + row_of(r) * a.hd : nullptr; },
                           a.hd / 8);
  }
  cp_async_commit();
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  int row_abs[2];  // the lane's two rows' positions; -1 (no key kept) for padding rows
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    row_abs[h] = r < n_rows ? abs0 + r / gn : -1;
  }
  FwdRows<T, D> f;
  f.init();
  unsigned qf[kQRegs ? D / 16 : 1][4];
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  if constexpr (kQRegs) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) frag_a<P>(qf[kc], q_s, 16 * warp, 16 * kc);
    __syncthreads();  // Q's rows are read: ring stage 1 (int8 pages: the T stage) takes tile 1
  }
  const float sl2 = a.scale * kLog2e;
  auto fq = [&](int kc, unsigned (&fa)[4]) {  // Q's (int8 pages: Q * key_scale's) k-chunk kc
    if constexpr (kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[e] = qf[kc][e];
    } else {
      frag_a<P>(fa, q_s, 16 * warp, 16 * kc);
    }
  };

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i & 1, j0 = i * BK, slot = i % 3;
    if (i + 1 < n_tiles) load_kv(i + 1, st ^ 1);
    cp_async_commit();
    if (i + 2 < n_tiles) locate(i + 2);  // its table loads overlap this tile's products
    cp_async_wait<1>();
    __syncthreads();
    bool full = j0 + BK <= abs0 + 1;  // every key at or below the tile's first row
#pragma unroll
    for (int w = 0; w < BK / 32; ++w) full = full && slot_ok[slot][w];
    auto keep = [&](int h, int c) { return key_off[slot][c] >= 0 && j0 + c <= row_abs[h]; };
    if constexpr (kInt8) {
      constexpr int CH = D / 16;
      const int8_t* r8 = ring8 + st * 2 * BK * D;
      for (int i8 = tid; i8 < 2 * BK * CH; i8 += NTH) {
        const int rr = i8 / CH, c = i8 % CH;
        const int4 raw = *reinterpret_cast<const int4*>(r8 + rr * D + c * 16);
        const int8_t* v8 = reinterpret_cast<const int8_t*>(&raw);
        unsigned w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = bits32(Pair<T>::pack(static_cast<float>(v8[2 * e]), static_cast<float>(v8[2 * e + 1])));
        int4* dst = reinterpret_cast<int4*>(kv_t + rr * P + c * 16);
        dst[0] = make_int4(w[0], w[1], w[2], w[3]);
        dst[1] = make_int4(w[4], w[5], w[6], w[7]);
      }
      __syncthreads();
      float s[BK / 8][4];
      zero_frags(s);
      mma_abt<T, P, D, BK / 8>(s, fq, kv_t);
      f.template step<BK>(s, kv_t + BK * P, sl2, full, keep);
    } else {
      const T* ks = ts + st * 2 * BK * P;
      f.template tile<BK>(fq, ks, ks + BK * P, sl2, full, keep);
    }
    __syncthreads();  // this stage (and slot) is consumed before the next copies overwrite it
  }

  float inv[2], lse[2];
  bool seen[2];
  f.finish(inv, lse, seen);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    if (r < n_rows) {
      T* o = out + row_of(r) * a.hd;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3);
        if (col >= a.hd) continue;
        float x0 = f.acc[n][2 * h] * inv[h], x1 = f.acc[n][2 * h + 1] * inv[h];
        if constexpr (kInt8) {
          x0 *= a.v_scale[kvh * a.hd + col];
          x1 *= a.v_scale[kvh * a.hd + col + 1];
        }
        store_pair(o + col, x0, x1);
      }
    }
  }
}

// -- launchers ----------------------------------------------------------------------

// fp32 takes the scalar kernel, bf16 / fp16 the tensor-core one (a route by dtype)
template <typename T, typename TC, int D>
int launch_prefill(const T* q, const TC* kc, const TC* vc, T* out, int max_q_len, const PrefillArgs& a,
                   cudaStream_t stream) {
  const int tpt = kRows / a.gsize;
  const int q_tiles = (max_q_len + tpt - 1) / tpt;
  if constexpr (std::is_same_v<T, float>) {
    constexpr size_t smem = prefill_smem_floats<D>() * sizeof(float);
    if (int rc = set_smem(paged_prefill_fma<T, TC, D>, smem)) return rc;
    const dim3 grid(q_tiles, a.hkv * a.chunks, a.B);
    paged_prefill_fma<T, TC, D><<<grid, kPreThreads, smem, stream>>>(
        q, kc, vc, a.k_scale, a.v_scale, a.cu_q, a.cu_kv, a.block_tables, out, a.hq, a.hkv, a.hd, a.gsize, a.chunks,
        a.block_size, a.max_blocks, a.page_stride, a.tok_stride, a.head_stride, a.scale, a.abab);
  } else {
    using C = PreMma<T, TC, D>;
    if (int rc = set_smem(paged_prefill_mma<T, TC, D>, C::kBytes)) return rc;
    PrefillArgs args = a;
    args.q_tiles = q_tiles;
    const int64_t blocks = static_cast<int64_t>(q_tiles) * a.B * a.hkv * a.chunks;
    if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    paged_prefill_mma<T, TC, D><<<static_cast<unsigned>(blocks), C::NTH, C::kBytes, stream>>>(q, kc, vc, out, args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (T, hq, D) contiguous; cu_q (B+1,) int32; cu_kv (B+1,) int32 or
// null (kv_len = q_len); caches addressed as
// page * page_stride + token * tok_stride + kv_head * head_stride + d, in
// q's dtype, or int8 when kv_int8 with k_scale/v_scale (hkv, D) fp32;
// block_tables (B, max_blocks) int32. max_q_len bounds the grid. hd a
// multiple of 16 up to 256; any hq a multiple of hkv (groups over 64 in
// chunks).
extern "C" int mojo_paged_prefill(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
                                  const void* v_scale, const void* cu_q, const void* cu_kv,
                                  const void* block_tables, void* out, int B, int max_q_len, int hq, int hkv, int hd,
                                  int block_size, int max_blocks, int page_stride, int tok_stride, int head_stride,
                                  float scale, int abab, int kv_int8, int dtype, void* stream) {
  if (B <= 0 || max_q_len <= 0) return static_cast<int>(cudaSuccess);
  if (hkv <= 0 || hq % hkv != 0 || block_size <= 0 || hd <= 0 || hd % 16 != 0 || hd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = hq / hkv;
  const int chunks = (group + kRows - 1) / kRows;
  const int gsize = (group + chunks - 1) / chunks;
  if (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PrefillArgs a{static_cast<const int*>(cu_q), static_cast<const int*>(cu_kv),
                      static_cast<const int*>(block_tables), static_cast<const float*>(k_scale),
                      static_cast<const float*>(v_scale), B, 0, hq, hkv, hd, gsize, chunks, block_size, max_blocks,
                      page_stride, tok_stride, head_stride, scale, abab};
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_FLASH_DISPATCH_PADDED(dtype, hd, {
    rc = kv_int8 ? launch_prefill<T, int8_t, D>(static_cast<const T*>(q), static_cast<const int8_t*>(k_cache),
                                                static_cast<const int8_t*>(v_cache), static_cast<T*>(out), max_q_len,
                                                a, s)
                 : launch_prefill<T, T, D>(static_cast<const T*>(q), static_cast<const T*>(k_cache),
                                           static_cast<const T*>(v_cache), static_cast<T*>(out), max_q_len, a, s);
  });
  return rc;
}
