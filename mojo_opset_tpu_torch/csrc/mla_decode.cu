// Kernel I: absorbed MLA attention over the paged latent cache, for decode
// and, one query token at a time, for prefill.
//
// Replaces the JAX package's backends/pallas/kernels/mla_decode.py:151
// (mla_decode_absorbed, body _mla_decode_kernel :37). After absorbing
// kv_b_proj into the queries (score = (W_uk^T q_nope) . c + q_pe . pe, out =
// W_uv (p . c)), MLA is multi-query attention in the latent space: one shared
// "head" of width r (latent) + dr (rope), H query heads. The PV product
// reuses the latent slab, so a cached position costs (r + dr) elements read
// and nothing more. Row i of the launch attends over the first
// row_lens[i] positions of sequence row_seqs[i] (of sequence i when
// row_seqs is null): decode passes its batch rows and their lengths,
// prefill passes each packed query row with its causal limit
// min(kv_len, q_abs + 1). The output is the normalized latent acc / l
// (R, H, r) fp32, or 0 where no position was attended; an optional
// per-head sink adds exp(sink - m) to l at the end (backends/xla/operators/
// mla.py:42-48); W_uv is applied by the caller.
//
// Bound on the H100: at decode the bytes of the latent pages (~1.15 KB a
// position in bf16); in prefill's row mode the operations, 2 H (2r + dr)
// per (row, position) pair (4 H r + 2 H dr with P split, below).
//
// bf16 / fp16 (mla_mma_kernel): a block is 8 warps over a tile of 64 query
// rows, the 64 heads h0 .. h0 + 63 of one row (heads past H are zero rows,
// never stored), and a column block of the latent: CB = 512, 256 or 128
// columns, each warp owning CB / 8 of them for all 64 rows (at r 512 the
// 64 x 512 fp32 accumulator is 128 registers a thread). The tile's queries
// [q_lat | q_pe] sit in shared memory for the whole walk (64 rows at a
// pitch of K + 8 elements, K = r + dr rounded up to 16, zero-filled past
// it); the row's positions stream through a ring of 32-position stages
// (two, or one where two do not fit the 227 KB), each position's
// [c | pe] row copied by cp.async into one row of the stage. A stage's
// table entries are found two stages ahead by one warp (as kernel D does),
// so no copy waits on a table load; pages < 0 and positions past the
// limit are zero-filled and never read. Per stage:
//   S = [q_lat | q_pe] [c | pe]^T, 64 x 32, with mma.sync.m16n8k16 (bf16 x
//   bf16 or fp16 x fp16 products, exact, fp32 sums), warp w computing
//   rows 16 (w % 4) .. and positions 16 (w / 4) ..; the scores go to
//   shared memory once, for every warp;
//   an online softmax by row (4 threads a row), in fp32; P is split into
//   hi + lo of the working type (flash_tiles.cuh split_pair, as J and O do)
//   and stored beside the row's rescale;
//   acc = acc alpha + P c, each warp over its columns of the staged latent
//   (the same rows S read, through ldmatrix.trans), two MMAs (hi, lo) into
//   one accumulator: P keeps ~16 significant bits, within the fp32 ladder
//   chip_smoke.py holds I to, where one rounding of P to bf16 would not.
// Decode splits the KV walk: the grid is (row, head tile, column block,
// split), the split count from shapes alone (R, H, r and the table's
// width: backends/cuda/kernels/mla_decode.py split_count), about one
// wave of the SMs; each split takes a contiguous range of its row's
// positions, whole stages, from the row's own limit on the device. With
// several splits a block writes its unnormalized acc and its (m, l) to
// the caller's scratch and mla_merge_kernel combines them in split order
// (the sink folds in there); both orders are fixed, so the result repeats
// bit for bit. Prefill (many rows) takes one split and normalizes in the
// block. Rows go out last first: in a packed prefill batch the last
// rows of a sequence walk the longest prefixes, so they start first.
// Any r and dr that are whole 16-byte rows, while the tile and one stage
// fit in shared memory: a staged row (r + dr rounded up to 16, at least
// the column blocks' span) of at most kMaxRowI elements. The entry point
// sizes the ring from r and dr: two stages where they fit, else one.
//
// fp32 (mla_fma_kernel): scalar FMAs, the tensor cores having no exact
// fp32 product. One block per (query row, group of 16 heads): the block
// walks its row's positions 64 at a time, staged in shared memory as fp32,
// each warp scoring its 2 heads and keeping their online softmax in
// registers, then every thread accumulating p . c for its 2 latent
// columns of all 16 heads. r <= 512, r + dr <= 576; no split.
#include "flash_tiles.cuh"

namespace {

using namespace mojo_flash;

// -- fp32: scalar FMAs ----------------------------------------------------------------

constexpr int kMlaThreads = 256;
constexpr int kMlaHeads = 16;  // query heads per block: 2 per warp
constexpr int kMlaTile = 64;   // cached positions per step: 2 per lane
constexpr int kMlaMaxR = 2 * kMlaThreads;
constexpr int kMlaMaxK = 576;

// a shared-memory row of K floats: K % 4 == 0, and 4 floats of padding put
// neighbouring rows on other banks for the score loop's float4 reads
__host__ __device__ constexpr int row_stride(int K) { return K + 4; }

size_t smem_bytes(int K) {
  return sizeof(float) * (static_cast<size_t>(kMlaHeads + kMlaTile) * row_stride(K) + kMlaHeads * kMlaTile +
                          3 * kMlaHeads) +
         sizeof(int) * kMlaTile;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <typename T>
__global__ void __launch_bounds__(kMlaThreads)
mla_fma_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe, const T* __restrict__ c_cache,
                  const T* __restrict__ pe_cache, const int* __restrict__ row_lens,
                  const int* __restrict__ row_seqs, const int* __restrict__ block_tables,
                  const float* __restrict__ sink, float* __restrict__ out, int H, int r, int dr, int block_size,
                  int max_blocks) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  const int K = r + dr;
  const int KS = row_stride(K);
  float* q_s = smem;                         // [kMlaHeads][KS] latent | rope queries
  float* kv_s = q_s + kMlaHeads * KS;        // [kMlaTile][KS] latent | rope keys of this step
  float* p_s = kv_s + kMlaTile * KS;         // [kMlaHeads][kMlaTile] probabilities of this step
  float* a_s = p_s + kMlaHeads * kMlaTile;   // [kMlaHeads] this step's rescale of the accumulators
  float* m_s = a_s + kMlaHeads;              // [kMlaHeads] final running max
  float* l_s = m_s + kMlaHeads;              // [kMlaHeads] final running sum
  int* ok_s = reinterpret_cast<int*>(l_s + kMlaHeads);  // [kMlaTile] position attended

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * kMlaHeads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seq = row_seqs == nullptr ? row : row_seqs[row];
  const int limit = row_lens[row];
  const int* table = block_tables + static_cast<int64_t>(seq) * max_blocks;

  for (int i = tid; i < kMlaHeads * K; i += kMlaThreads) {
    const int h = i / K, k = i % K;
    float v = 0.f;  // heads past H score zeros and are never written
    if (h0 + h < H) {
      const int64_t hh = static_cast<int64_t>(row) * H + h0 + h;
      v = k < r ? mojo_to_float(q_lat[hh * r + k]) : mojo_to_float(q_pe[hh * dr + (k - r)]);
    }
    q_s[h * KS + k] = v;
  }

  const int d0 = 2 * tid;  // this thread's latent columns in the PV product
  float acc[kMlaHeads][2];
#pragma unroll
  for (int h = 0; h < kMlaHeads; ++h) acc[h][0] = acc[h][1] = 0.f;
  const int sh = 2 * warp;  // this warp's heads in the score product
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int row_chunks = K / VE;
  const int r_chunks = r / VE;
  for (int j0 = 0; j0 < limit; j0 += kMlaTile) {
    __syncthreads();  // q_s is staged, and the previous step's kv_s and p_s are read
    for (int i = tid; i < kMlaTile * row_chunks; i += kMlaThreads) {
      const int jj = i / row_chunks, cc = i % row_chunks;
      const int pos = j0 + jj;
      const int lb = pos / block_size;
      const int page = pos < limit && lb < max_blocks ? table[lb] : -1;
      float f[VE];
      if (page >= 0) {
        const int64_t tok = static_cast<int64_t>(page) * block_size + pos % block_size;
        const T* src = cc < r_chunks ? c_cache + tok * r + cc * VE : pe_cache + tok * dr + (cc - r_chunks) * VE;
        mojo_load_row<T, VE>(src, f);
      } else {
#pragma unroll
        for (int e = 0; e < VE; ++e) f[e] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(kv_s + jj * KS + cc * VE);
#pragma unroll
      for (int e = 0; e < VE / 4; ++e) dst[e] = make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
      if (cc == 0) ok_s[jj] = page >= 0;
    }
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [head][position lane, lane + 32]
    {
      const float* qa = q_s + sh * KS;
      const float* qb = qa + KS;
      const float* ka = kv_s + lane * KS;
      const float* kb = ka + 32 * KS;
#pragma unroll 4
      for (int k = 0; k < K; k += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qa + k);
        const float4 b = *reinterpret_cast<const float4*>(qb + k);
        const float4 x = *reinterpret_cast<const float4*>(ka + k);
        const float4 y = *reinterpret_cast<const float4*>(kb + k);
        s[0][0] = dot4(a, x, s[0][0]);
        s[0][1] = dot4(a, y, s[0][1]);
        s[1][0] = dot4(b, x, s[1][0]);
        s[1][1] = dot4(b, y, s[1][1]);
      }
    }
    const bool ok0 = ok_s[lane] != 0, ok1 = ok_s[lane + 32] != 0;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const float v0 = ok0 ? s[g][0] : -INFINITY;
      const float v1 = ok1 ? s[g][1] : -INFINITY;
      const float m_new = fmaxf(m[g], mojo_warp_max(fmaxf(v0, v1)));
      const float p0 = ok0 ? expf(v0 - m_new) : 0.f;  // ok implies a finite m_new
      const float p1 = ok1 ? expf(v1 - m_new) : 0.f;
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[g] - m_new);
      l[g] = l[g] * alpha + mojo_warp_sum(p0 + p1);
      m[g] = m_new;
      p_s[(sh + g) * kMlaTile + lane] = p0;
      p_s[(sh + g) * kMlaTile + lane + 32] = p1;
      if (lane == 0) a_s[sh + g] = alpha;
    }
    __syncthreads();

    if (d0 < r) {
#pragma unroll
      for (int h = 0; h < kMlaHeads; ++h) {
        acc[h][0] *= a_s[h];
        acc[h][1] *= a_s[h];
      }
      // positions past the limit hold p = 0 and zero rows: round up to 4
      const int n = (min(kMlaTile, limit - j0) + 3) & ~3;
      for (int j = 0; j < n; j += 4) {
        const float2 c0 = *reinterpret_cast<const float2*>(kv_s + (j + 0) * KS + d0);
        const float2 c1 = *reinterpret_cast<const float2*>(kv_s + (j + 1) * KS + d0);
        const float2 c2 = *reinterpret_cast<const float2*>(kv_s + (j + 2) * KS + d0);
        const float2 c3 = *reinterpret_cast<const float2*>(kv_s + (j + 3) * KS + d0);
#pragma unroll
        for (int h = 0; h < kMlaHeads; ++h) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + h * kMlaTile + j);
          acc[h][0] = fmaf(p.w, c3.x, fmaf(p.z, c2.x, fmaf(p.y, c1.x, fmaf(p.x, c0.x, acc[h][0]))));
          acc[h][1] = fmaf(p.w, c3.y, fmaf(p.z, c2.y, fmaf(p.y, c1.y, fmaf(p.x, c0.y, acc[h][1]))));
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      m_s[sh + g] = m[g];
      l_s[sh + g] = l[g];
    }
  }
  __syncthreads();
  if (d0 >= r) return;
#pragma unroll
  for (int h = 0; h < kMlaHeads; ++h) {
    if (h0 + h >= H) break;
    float lh = l_s[h];
    if (sink != nullptr && lh > 0.f) lh += expf(sink[h0 + h] - m_s[h]);
    const float inv = lh > 0.f ? 1.f / lh : 0.f;
    *reinterpret_cast<float2*>(out + (static_cast<int64_t>(row) * H + h0 + h) * r + d0) =
        make_float2(acc[h][0] * inv, acc[h][1] * inv);
  }
}


int launch_fma(const float* q_lat, const float* q_pe, const float* c_cache, const float* pe_cache, const int* row_lens,
               const int* row_seqs, const int* block_tables, const float* sink, float* out, int R, int H, int r,
               int dr, int block_size, int max_blocks, cudaStream_t s) {
  if (r % 4 != 0 || dr % 4 != 0 || r > kMlaMaxR || r + dr > kMlaMaxK) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mla_fma_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_bytes(kMlaMaxK)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(R, (H + kMlaHeads - 1) / kMlaHeads);
  mla_fma_kernel<float><<<grid, kMlaThreads, smem_bytes(r + dr), s>>>(
      q_lat, q_pe, c_cache, pe_cache, row_lens, row_seqs, block_tables, sink, out, H, r, dr, block_size, max_blocks);
  return static_cast<int>(cudaGetLastError());
}

// -- bf16 / fp16: tensor-core tiles -----------------------------------------------------

constexpr int kRowsI = 64;     // query rows (heads of one row) of a tile
constexpr int kWarpsI = 8;
constexpr int kThreadsI = kWarpsI * 32;
constexpr int kKeysI = 32;     // positions of a ring stage
constexpr int kSP = kKeysI + 4;  // fp32 pitch of the score tile
constexpr int kPP = kKeysI + 8;  // pitch of P's hi and lo tiles (elements)
constexpr int kMaxSplitsI = 256;
constexpr int kMaxSmemI = 227 * 1024 - 1024;  // dynamic shared memory a block may take (the slots are static)

struct MlaArgs {
  const void* q_lat;
  const void* q_pe;
  const void* c_cache;
  const void* pe_cache;
  const int* row_lens;
  const int* row_seqs;  // null: row i is sequence i
  const int* block_tables;
  const float* sink;    // null: no sink
  float* out;           // (R, H, r), written with one split
  float* part;          // with several splits: acc (R, H, splits, r), then (m, l) (R, H, splits, 2)
  int R, H, r, dr, block_size, max_blocks;
  int kp;               // pitch of the query and stage rows (elements)
  int head_tiles, col_blocks, splits, stages;
};

// bytes of dynamic shared memory: the query tile, the stages, the scores,
// P's hi and lo, and the rows' rescale, max and sum
__host__ __device__ constexpr int mma_smem_bytes(int kp, int stages) {
  return (kRowsI + stages * kKeysI) * kp * 2 + kRowsI * kSP * 4 + 2 * kRowsI * kPP * 2 + 3 * kRowsI * 4;
}

// the widest staged row one stage fits beside the query tile (the wrapper's
// takes, backends/cuda/kernels/mla_decode.py MAX_ROW, reads the same number)
constexpr int kMaxRowI = 1088;
static_assert(mma_smem_bytes(kMaxRowI + 8, 1) <= kMaxSmemI && mma_smem_bytes(kMaxRowI + 16 + 8, 1) > kMaxSmemI,
              "kMaxRowI is the widest 16-element row that one stage fits");

// flash_tiles.cuh's fragments at a pitch known only at run time (r and dr are the caller's)
template <typename T>
__device__ __forceinline__ void frag_a_rt(unsigned (&f)[4], const T* s, int pitch, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, s + (r0 + (lane & 15)) * pitch + c0 + (lane >> 4) * 8);
}
template <typename T>
__device__ __forceinline__ void frag_b_nk_rt(unsigned (&f)[4], const T* s, int pitch, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + ((lane >> 3) & 1) * 8);
}
template <typename T>
__device__ __forceinline__ void frag_b_kn_rt(unsigned (&f)[4], const T* s, int pitch, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(f, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + n0 + (lane >> 4) * 8);
}

// NT: n-tiles of 8 latent columns a warp owns (a column block is 64 NT columns)
template <typename T, int NT>
__global__ void __launch_bounds__(kThreadsI, 1) mla_mma_kernel(const MlaArgs a) {
  constexpr int CB = kWarpsI * NT * 8;
  extern __shared__ __align__(16) unsigned char mla_smem[];
  T* q_s = reinterpret_cast<T*>(mla_smem);                     // [64][kp]
  T* ring = q_s + kRowsI * a.kp;                                // [stages][32][kp]
  float* s_s = reinterpret_cast<float*>(ring + a.stages * kKeysI * a.kp);  // [64][kSP]
  T* p_hi = reinterpret_cast<T*>(s_s + kRowsI * kSP);           // [64][kPP]
  T* p_lo = p_hi + kRowsI * kPP;
  float* alpha_s = reinterpret_cast<float*>(p_lo + kRowsI * kPP);  // [64]
  float* m_s = alpha_s + kRowsI;
  float* l_s = m_s + kRowsI;
  __shared__ int64_t key_tok[3][kKeysI];  // a stage's token rows (-1: not read), two stages ahead

  // blockIdx.x = (row counted from the last, head tile, column block, split), split fastest
  int x = blockIdx.x;
  const int split = x % a.splits;
  x /= a.splits;
  const int cb = x % a.col_blocks;
  x /= a.col_blocks;
  const int h0 = (x % a.head_tiles) * kRowsI;
  const int row = a.R - 1 - x / a.head_tiles;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int seq = a.row_seqs == nullptr ? row : a.row_seqs[row];
  const int limit = a.row_lens[row];
  // this split's positions [lo, hi), whole stages
  const int span = ((limit + a.splits - 1) / a.splits + kKeysI - 1) / kKeysI * kKeysI;
  const int lo = min(limit, split * span);
  const int hi = min(limit, lo + span);
  const int n_tiles = (hi - lo + kKeysI - 1) / kKeysI;
  const int r = a.r, dr = a.dr;
  const int64_t row_h0 = static_cast<int64_t>(row) * a.H + h0;

  if (n_tiles == 0) {  // nothing attended: o = 0, or an empty partial (m = -inf, l = 0)
    for (int i = tid; i < kRowsI * CB; i += kThreadsI) {
      const int rr = i / CB, col = cb * CB + i % CB;
      if (h0 + rr >= a.H || col >= r) continue;
      if (a.splits == 1) {
        a.out[(row_h0 + rr) * r + col] = 0.f;
      } else if (cb == 0 && i % CB == 0) {
        float* ml = a.part + static_cast<int64_t>(a.R) * a.H * a.splits * r + ((row_h0 + rr) * a.splits + split) * 2;
        ml[0] = -INFINITY;
        ml[1] = 0.f;
      }
    }
    return;
  }

  const T* c_cache = static_cast<const T*>(a.c_cache);
  const T* pe_cache = static_cast<const T*>(a.pe_cache);
  const int* table = a.block_tables + static_cast<int64_t>(seq) * a.max_blocks;
  const int kc_r = r / 8, kc_all = (r + dr) / 8, kc_row = (a.kp - 8) / 8;  // 16-byte chunks of a row

  auto locate = [&](int i) {  // stage i's token rows into slot i % 3
    if (tid < kKeysI) {
      const int pos = lo + i * kKeysI + tid;
      const int lb = pos / a.block_size;
      const int page = pos < hi && lb < a.max_blocks ? table[lb] : -1;
      key_tok[i % 3][tid] = page < 0 ? -1 : static_cast<int64_t>(page) * a.block_size + pos % a.block_size;
    }
  };
  auto load_kv = [&](int i, int st) {  // stage i's [c | pe] rows into ring stage st, zeros past r + dr
    const int64_t* tok = key_tok[i % 3];
    T* dst = ring + st * kKeysI * a.kp;
    for (int idx = tid; idx < kKeysI * kc_row; idx += kThreadsI) {
      const int k = idx / kc_row, c = idx % kc_row;
      const int64_t t = tok[k];
      const bool ok = t >= 0 && c < kc_all;
      const T* src = !ok ? c_cache : c < kc_r ? c_cache + t * r + c * 8 : pe_cache + t * dr + (c - kc_r) * 8;
      cp_async16(dst + k * a.kp + c * 8, src, ok);
    }
  };

  locate(0);
  if (n_tiles > 1) locate(1);
  {  // the tile's queries [q_lat | q_pe], heads past H and columns past r + dr zero
    const T* ql = static_cast<const T*>(a.q_lat);
    const T* qp = static_cast<const T*>(a.q_pe);
    for (int idx = tid; idx < kRowsI * kc_row; idx += kThreadsI) {
      const int rr = idx / kc_row, c = idx % kc_row;
      const bool ok = h0 + rr < a.H && c < kc_all;
      const int64_t hh = row_h0 + rr;
      const T* src = !ok ? ql : c < kc_r ? ql + hh * r + c * 8 : qp + hh * dr + (c - kc_r) * 8;
      cp_async16(q_s + rr * a.kp + c * 8, src, ok);
    }
  }
  __syncthreads();  // slots 0 and 1 are written
  load_kv(0, 0);
  cp_async_commit();

  float acc[4][NT][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) zero_frags(acc[mt]);
  // the softmax's row and quarter of the stage's positions: every thread of a row keeps its m, and its share of l
  const int srow = tid / 4, sq = tid % 4;
  float m_run = -INFINITY, l_run = 0.f;
  const int smt = warp % 4, skey = (warp / 4) * 16;  // this warp's rows and positions of S
  const int wc = cb * CB + warp * NT * 8;            // this warp's first latent column
  const int kp = a.kp, k16 = (r + dr + 15) / 16;

  for (int i = 0; i < n_tiles; ++i) {
    const int st = a.stages == 2 ? (i & 1) : 0, slot = i % 3;
    if (a.stages == 2 && i + 1 < n_tiles) load_kv(i + 1, st ^ 1);
    cp_async_commit();
    if (i + 2 < n_tiles) locate(i + 2);  // its table loads overlap this stage's products
    if (a.stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kv = ring + st * kKeysI * kp;

    {  // S: rows 16 smt .., positions skey .. skey + 15, over the k-chunks of [q_lat | q_pe]
      float s[2][4];
      zero_frags(s);
      for (int kc = 0; kc < k16; ++kc) {
        unsigned fa[4], fb[4];
        frag_a_rt(fa, q_s, kp, 16 * smt, 16 * kc);
        frag_b_nk_rt(fb, kv, kp, skey, 16 * kc);
        mma_pair<T>(s[0], s[1], fa, fb);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = 16 * smt + lane / 4 + 8 * h, col = skey + 8 * n + 2 * (lane & 3);
          const bool ok0 = key_tok[slot][col] >= 0, ok1 = key_tok[slot][col + 1] >= 0;
          *reinterpret_cast<float2*>(s_s + rr * kSP + col) =
              make_float2(ok0 ? s[n][2 * h] : -INFINITY, ok1 ? s[n][2 * h + 1] : -INFINITY);
        }
    }
    __syncthreads();

    {  // online softmax of row srow over positions 8 sq .. 8 sq + 7; P as hi + lo
      const float4 v0 = *reinterpret_cast<const float4*>(s_s + srow * kSP + 8 * sq);
      const float4 v1 = *reinterpret_cast<const float4*>(s_s + srow * kSP + 8 * sq + 4);
      float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      float mx = v[0];
#pragma unroll
      for (int e = 1; e < 8; ++e) mx = fmaxf(mx, v[e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no position yet: p = 0, nothing to rescale
      const float alpha = expf(m_run - base);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = expf(v[e] - base);
        sum += v[e];
      }
      l_run = l_run * alpha + sum;
      m_run = m_new;
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        unsigned hi2, lo2;
        split_pair<T>(v[e], v[e + 1], hi2, lo2);
        *reinterpret_cast<unsigned*>(p_hi + srow * kPP + 8 * sq + e) = hi2;
        *reinterpret_cast<unsigned*>(p_lo + srow * kPP + 8 * sq + e) = lo2;
      }
      if (sq == 0) alpha_s[srow] = alpha;
    }
    __syncthreads();

    // acc = acc alpha + P c over this warp's columns
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float a0 = alpha_s[16 * mt + lane / 4], a1 = alpha_s[16 * mt + lane / 4 + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[mt][n][0] *= a0;
        acc[mt][n][1] *= a0;
        acc[mt][n][2] *= a1;
        acc[mt][n][3] *= a1;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kKeysI / 16; ++kc) {
      unsigned ph[4][4], pl[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        frag_a<kPP>(ph[mt], p_hi, 16 * mt, 16 * kc);
        frag_a<kPP>(pl[mt], p_lo, 16 * mt, 16 * kc);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned fb[4];
        frag_b_kn_rt(fb, kv, kp, 16 * kc, wc + 16 * np);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_pair<T>(acc[mt][2 * np], acc[mt][2 * np + 1], ph[mt], fb);
          mma_pair<T>(acc[mt][2 * np], acc[mt][2 * np + 1], pl[mt], fb);
        }
      }
    }
    __syncthreads();  // the stage, its slot, the scores and P are consumed
    if (a.stages == 1 && i + 1 < n_tiles) load_kv(i + 1, 0);
  }

  {  // the row's sum, its quarters added in one order on every lane
    float t = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    if (sq == 0) {
      m_s[srow] = m_run;
      l_s[srow] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = 16 * mt + lane / 4 + 8 * h;
      if (h0 + rr >= a.H) continue;
      float inv = 1.f;
      float* dst;
      if (a.splits == 1) {
        float l = l_s[rr];
        if (a.sink != nullptr && l > 0.f) l += expf(a.sink[h0 + rr] - m_s[rr]);
        inv = l > 0.f ? 1.f / l : 0.f;
        dst = a.out + (row_h0 + rr) * r;
      } else {
        dst = a.part + ((row_h0 + rr) * a.splits + split) * r;
        if (cb == 0 && warp == 0 && (lane & 3) == 0) {
          float* ml = a.part + static_cast<int64_t>(a.R) * a.H * a.splits * r + ((row_h0 + rr) * a.splits + split) * 2;
          ml[0] = m_s[rr];
          ml[1] = l_s[rr];
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = wc + 8 * n + 2 * (lane & 3);
        if (col < r) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(acc[mt][n][2 * h] * inv, acc[mt][n][2 * h + 1] * inv);
        }
      }
    }
}

// out[row][h] from the splits' partials, in split order; a partial with
// m = -inf holds no position and is skipped (its acc is never written).
// One block per (head, row), a thread per 4 columns (16-byte loads); the
// sink joins the sum here.
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads)
mla_merge_kernel(const float* __restrict__ part, const float* __restrict__ sink, float* __restrict__ out, int R, int H,
                 int r, int splits) {
  __shared__ float w_s[kMaxSplitsI], l_s[kMaxSplitsI];
  __shared__ float warp_max[kMergeThreads / 32];
  __shared__ float total;
  const int h = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int64_t rh = static_cast<int64_t>(row) * H + h;
  const float* p = part + rh * splits * r;
  const float* ml = part + static_cast<int64_t>(R) * H * splits * r + rh * splits * 2;
  float mx = -INFINITY;
  for (int s = tid; s < splits; s += kMergeThreads) {
    const float m = ml[2 * s];
    w_s[s] = m;
    l_s[s] = ml[2 * s + 1];
    mx = fmaxf(mx, m);
  }
  mx = mojo_warp_max(mx);
  if (tid % 32 == 0) warp_max[tid / 32] = mx;
  __syncthreads();
  mx = warp_max[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) mx = fmaxf(mx, warp_max[w]);
  for (int s = tid; s < splits; s += kMergeThreads) w_s[s] = w_s[s] == -INFINITY ? 0.f : expf(w_s[s] - mx);
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += w_s[s] == 0.f ? 0.f : l_s[s] * w_s[s];
    if (sink != nullptr && sum > 0.f) sum += expf(sink[h] - mx);
    total = sum;
  }
  __syncthreads();
  const float inv = total > 0.f ? 1.f / total : 0.f;
  for (int d = 4 * tid; d < r; d += 4 * kMergeThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float wgt = w_s[s];
      if (wgt == 0.f) continue;
      const float4 v = *reinterpret_cast<const float4*>(p + static_cast<int64_t>(s) * r + d);
      acc.x += v.x * wgt;
      acc.y += v.y * wgt;
      acc.z += v.z * wgt;
      acc.w += v.w * wgt;
    }
    *reinterpret_cast<float4*>(out + rh * r + d) = make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
}

template <typename T, int NT>
int launch_mma_nt(const MlaArgs& a, cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(mla_mma_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemI);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int bytes = mma_smem_bytes(a.kp, a.stages);
  const int64_t blocks = static_cast<int64_t>(a.R) * a.head_tiles * a.col_blocks * a.splits;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  mla_mma_kernel<T, NT><<<static_cast<unsigned>(blocks), kThreadsI, bytes, s>>>(a);
  if (const cudaError_t e = cudaGetLastError(); e != cudaSuccess) return static_cast<int>(e);
  if (a.splits > 1) {
    mla_merge_kernel<<<dim3(a.H, a.R), kMergeThreads, 0, s>>>(a.part, a.sink, a.out, a.R, a.H, a.r, a.splits);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mma(const MlaArgs& a, int col_tile, cudaStream_t s) {
  switch (col_tile) {
    case 512:
      return launch_mma_nt<T, 8>(a, s);
    case 256:
      return launch_mma_nt<T, 4>(a, s);
    case 128:
      return launch_mma_nt<T, 2>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_lat (R, H, r) and q_pe (R, H, dr), scale folded in; c_cache (N, 1, bs, r)
// and pe_cache (N, 1, bs, dr); all contiguous in `dtype`, 16-byte aligned,
// r and dr whole 16-byte rows. row_lens (R,), row_seqs (R,) or null,
// block_tables (B, max_blocks) int32; sink (H,) fp32 or null; out (R, H, r)
// fp32. bf16 / fp16: col_tile 512, 256 or 128 latent columns a block (the
// wrapper's column_tile, from r), a staged row of at most kMaxRowI
// elements, 1 <= splits <= 256, with splits > 1 `partial` holds
// R * H * splits * (r + 2) fp32 of scratch (acc rows, then (m, l) pairs).
// fp32: r <= 512, r + dr <= 576, one split.
extern "C" int mojo_mla_decode(const void* q_lat, const void* q_pe, const void* c_cache, const void* pe_cache,
                               const void* row_lens, const void* row_seqs, const void* block_tables,
                               const void* sink, void* out, void* partial, int R, int H, int r, int dr,
                               int block_size, int max_blocks, int col_tile, int splits, int dtype,
                               void* stream) {
  if (R <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (r <= 0 || dr <= 0 || block_size <= 0 || splits < 1 || splits > kMaxSplitsI ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(row_lens);
  const int* seqs = static_cast<const int*>(row_seqs);
  const int* bt = static_cast<const int*>(block_tables);
  const float* sk = static_cast<const float*>(sink);
  float* o = static_cast<float*>(out);
  if (dtype == kMojoF32) {
    if (splits != 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch_fma(static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
                      static_cast<const float*>(c_cache), static_cast<const float*>(pe_cache), lens, seqs, bt, sk, o,
                      R, H, r, dr, block_size, max_blocks, s);
  }
  if (r % 8 != 0 || dr % 8 != 0 || col_tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (r + col_tile - 1) / col_tile;
  const int k16 = (r + dr + 15) / 16 * 16;
  const int row = k16 > col_blocks * col_tile ? k16 : col_blocks * col_tile;
  if (row > kMaxRowI) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = row + 8;  // 8 more elements spread ldmatrix rows over the banks
  const int stages = mma_smem_bytes(kp, 2) <= kMaxSmemI ? 2 : 1;
  const MlaArgs a{q_lat, q_pe, c_cache, pe_cache, lens, seqs, bt, sk, o, static_cast<float*>(partial),
                  R, H, r, dr, block_size, max_blocks, kp, (H + kRowsI - 1) / kRowsI, col_blocks, splits, stages};
  if (dtype == kMojoBF16) return launch_mma<__nv_bfloat16>(a, col_tile, s);
  if (dtype == kMojoF16) return launch_mma<__half>(a, col_tile, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
