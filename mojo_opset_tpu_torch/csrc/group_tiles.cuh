// The row tiles of the grouped GEMMs, kernels H (group_gemm.cu) and R (group_quant_gemm.cu): a row tile belongs
// to one group and starts at that group's first row or BM rows after, found on the device from group_sizes, with
// the grid sized by a static bound (row_tiles), so the host never reads a count. group_gemm.cu's module note
// has the design.
#pragma once

#include "common.cuh"

// in an unnamed namespace: each source that includes it keeps its own copy
namespace {

// Block-wide exclusive prefix sum of one int per thread; `total` gets the
// sum over the block. `scratch` holds THREADS / 32 ints of shared memory.
template <int THREADS>
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    const int s = scratch[i];
    if (i < warp) before += s;
    total += s;
  }
  __syncthreads();  // scratch is reused by the next scan
  return before + incl - v;
}

struct TileInfo {
  int kind;    // 1: a group's row tile, 0: a surplus block
  int group;
  int row_lo;  // rows [row_lo, row_hi) of this tile
  int row_hi;
  int tiles;   // row tiles of all groups
  int filled;  // rows covered by the groups (<= M)
};

// Find row tile `t` of the groups from the counts on the device.
template <int THREADS, int BM>
__device__ void locate_tile(const int* __restrict__ group_sizes, int G, int M, int t, TileInfo& info,
                            int* scratch) {
  if (threadIdx.x == 0) info.kind = 0;
  __syncthreads();
  int row_carry = 0, tile_carry = 0;
  for (int base = 0; base < G; base += THREADS) {
    const int g = base + static_cast<int>(threadIdx.x);
    const int c = g < G ? max(group_sizes[g], 0) : 0;
    int chunk_rows, chunk_tiles;
    const int row_start = row_carry + block_exclusive_scan<THREADS>(c, scratch, chunk_rows);
    const int rows = max(0, min(c, M - row_start));
    const int tiles = (rows + BM - 1) / BM;
    const int tile_start = tile_carry + block_exclusive_scan<THREADS>(tiles, scratch, chunk_tiles);
    if (t >= tile_start && t < tile_start + tiles) {
      const int lo = row_start + (t - tile_start) * BM;
      info.kind = 1;
      info.group = g;
      info.row_lo = lo;
      info.row_hi = min(lo + BM, row_start + rows);
    }
    row_carry = min(row_carry + chunk_rows, M);
    tile_carry += chunk_tiles;
  }
  if (threadIdx.x == 0) {
    info.tiles = tile_carry;
    info.filled = row_carry;
  }
  __syncthreads();
}

inline int row_tiles(int M, int G, int bm) {
  // every tile holds at least one row, and no group wastes more than one tile
  const int64_t bound = static_cast<int64_t>((M + bm - 1) / bm) + G;
  return static_cast<int>(bound < M ? bound : M);
}

}  // namespace
