// Kernel I: absorbed MLA attention over the paged latent cache, for decode
// and, one query row at a time, for prefill.
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
// position in bf16), about a microsecond at the main shape; in prefill's
// row mode the operations, 2 * H * (2r + dr) per (row, position) pair.
// Design (simple first): one block per (query row, group of 16 heads),
// since one row's whole (H, r) fp32 accumulator (256 KB at H = 128) exceeds
// a block's shared memory. The block walks its row's positions 64 at a
// time: the 64 latent | rope rows go to shared memory as fp32 (pages < 0
// and positions past the limit as zeros, never read from device memory),
// each warp scores its 2 heads at 64 positions (scalar fp32 FMAs over
// float4 shared-memory reads, K = r + dr) and keeps their online softmax
// (m, l) in registers, then every thread accumulates p . c for its 2 latent
// columns of all 16 heads. fp32 arithmetic throughout, for bf16, fp16 and
// fp32 caches alike. Known limits: B * H / 16 blocks (32 at bs 4) leave
// most SMs idle at decode, and scalar FMAs leave the tensor cores idle;
// split-KV and mma.sync tiles are the later steps.
#include "common.cuh"

namespace {

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
mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe, const T* __restrict__ c_cache,
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

template <typename T>
int launch_mla(const void* q_lat, const void* q_pe, const void* c_cache, const void* pe_cache, const int* row_lens,
               const int* row_seqs, const int* block_tables, const float* sink, float* out, int R, int H, int r,
               int dr, int block_size, int max_blocks, cudaStream_t s) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  if (r % VE != 0 || dr % VE != 0) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // once per element type: the most any K needs
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes(kMlaMaxK)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(R, (H + kMlaHeads - 1) / kMlaHeads);
  mla_decode_kernel<T><<<grid, kMlaThreads, smem_bytes(r + dr), s>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe), static_cast<const T*>(c_cache),
      static_cast<const T*>(pe_cache), row_lens, row_seqs, block_tables, sink, out, H, r, dr, block_size,
      max_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat (R, H, r) and q_pe (R, H, dr), scale folded in; c_cache (N, 1, bs, r)
// and pe_cache (N, 1, bs, dr); all contiguous in `dtype`, 16-byte aligned,
// r and dr whole 16-byte rows, r <= 512, r + dr <= 576. row_lens (R,),
// row_seqs (R,) or null, block_tables (B, max_blocks) int32; sink (H,) fp32
// or null; out (R, H, r) fp32.
extern "C" int mojo_mla_decode(const void* q_lat, const void* q_pe, const void* c_cache, const void* pe_cache,
                               const void* row_lens, const void* row_seqs, const void* block_tables,
                               const void* sink, void* out, int R, int H, int r, int dr, int block_size,
                               int max_blocks, int dtype, void* stream) {
  if (R <= 0 || H <= 0) return static_cast<int>(cudaSuccess);
  if (r <= 0 || r > kMlaMaxR || dr <= 0 || r + dr > kMlaMaxK || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(row_lens);
  const int* seqs = static_cast<const int*>(row_seqs);
  const int* bt = static_cast<const int*>(block_tables);
  const float* sk = static_cast<const float*>(sink);
  float* o = static_cast<float*>(out);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  MOJO_DISPATCH_DTYPE(dtype, T, {
    rc = launch_mla<T>(q_lat, q_pe, c_cache, pe_cache, lens, seqs, bt, sk, o, R, H, r, dr, block_size, max_blocks,
                       s);
  });
  return rc;
}
