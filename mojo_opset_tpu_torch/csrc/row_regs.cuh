// Rows held in registers, shared by kernel A (csrc/rmsnorm.cu) and kernel E
// (csrc/rmsnorm_quant.cu): a row of D elements is split evenly over TPR
// threads of VPT 16-byte vectors each (thread `sub` of a row holds vectors
// sub, sub + TPR, ...), 128-thread blocks take 128 / TPR rows at a time, and
// the grid is no larger than the blocks the card holds at once, cut so that
// every block takes the same number of row groups (no partial last wave).
#pragma once

#include <cuda_runtime.h>

// The (threads a row, vectors a thread) layouts that norms.ROW_LAYOUTS names; another pair is refused
#define MOJO_ROW_LAYOUTS(X) \
  X(8, 2) X(16, 2) X(32, 2) X(32, 4) X(32, 6) X(32, 10) X(32, 12) X(64, 8) X(64, 10) X(64, 12) X(128, 7)

// Blocks of `kernel` (launched with `threads` threads and no dynamic shared memory) the card holds at once
template <typename Kernel>
int mojo_resident_blocks(Kernel kernel, int threads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// The grid for `groups` row groups: at most `resident` blocks, each taking the same number of groups
inline int mojo_even_rounds_grid(int groups, int resident) {
  const int rounds = (groups + resident - 1) / resident;
  return (groups + rounds - 1) / rounds;
}
