// Native host-side paged-KV block allocator.
//
// The JAX package's runtime/native/block_allocator.cpp with one change:
// the free stack is a caller buffer too, so the session's numpy state
// (free stack, count, block tables, sequence lengths) is the one state
// that both this allocator and the numpy fallback read and write. The
// device side is the session's KV cache tensors; the work here sits on
// the per-step serving path (each decode step's reserve) between CUDA
// graph replays.
//
// Plain C ABI so Python binds via ctypes. Every buffer is owned by the
// caller (numpy int32 arrays, which must outlive the allocator): the free
// stack (free_stack[0..*num_free) are free, the top handed out first),
// its count, and the tables passed per call.

#include <cstdint>

namespace {

struct Allocator {
  int32_t batch;
  int32_t max_blocks_per_seq;
  int32_t block_size;
  int32_t* free_stack;  // caller's buffer of total_blocks entries
  int32_t* num_free;    // caller's one-element count
};

inline int32_t ceil_div(int32_t a, int32_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

Allocator* mojo_alloc_create(int32_t batch, int32_t max_blocks_per_seq,
                             int32_t block_size, int32_t* free_stack,
                             int32_t* num_free) {
  if (batch <= 0 || max_blocks_per_seq <= 0 || block_size <= 0 ||
      free_stack == nullptr || num_free == nullptr)
    return nullptr;
  auto* a = new Allocator();
  a->batch = batch;
  a->max_blocks_per_seq = max_blocks_per_seq;
  a->block_size = block_size;
  a->free_stack = free_stack;
  a->num_free = num_free;
  return a;
}

void mojo_alloc_destroy(Allocator* a) { delete a; }

// Reserve space for q_lens[i] appended tokens on every sequence.
// seq_lens / block_tables are caller buffers updated in place;
// context_out[i] receives the pre-reserve length (the attention
// context). Transactional: on OOM returns -1, on a sequence past its
// table -2, and mutates NOTHING.
int32_t mojo_alloc_reserve(Allocator* a, const int32_t* q_lens,
                           int32_t* seq_lens, int32_t* block_tables,
                           int32_t* context_out) {
  const int32_t bs = a->block_size;
  int64_t needed = 0;
  for (int32_t i = 0; i < a->batch; ++i) {
    const int32_t oldb = ceil_div(seq_lens[i], bs);
    const int32_t newb = ceil_div(seq_lens[i] + q_lens[i], bs);
    if (newb > a->max_blocks_per_seq) return -2;  // per-seq table overflow
    const int32_t* row =
        block_tables + static_cast<int64_t>(i) * a->max_blocks_per_seq;
    for (int32_t b = oldb; b < newb; ++b)
      // valid entries past the length are blocks this sequence still
      // owns from a rolled-back reserve (speculative rewind) — they get
      // reused, not re-allocated (overwriting them would leak)
      if (row[b] < 0) ++needed;
  }
  if (needed > *a->num_free) return -1;

  for (int32_t i = 0; i < a->batch; ++i) {
    const int32_t oldb = ceil_div(seq_lens[i], bs);
    const int32_t newb = ceil_div(seq_lens[i] + q_lens[i], bs);
    int32_t* row = block_tables + static_cast<int64_t>(i) * a->max_blocks_per_seq;
    // Hand out stack entries one at a time from the top — bit-identical
    // tables to the numpy fallback's per-entry pop.
    for (int32_t b = oldb; b < newb; ++b)
      if (row[b] < 0) row[b] = a->free_stack[--*a->num_free];
    context_out[i] = seq_lens[i];
    seq_lens[i] += q_lens[i];
  }
  return 0;
}

// Return every block of one finished sequence to the free stack and
// clear its table row (continuous-batching slot reuse).
void mojo_alloc_release(Allocator* a, int32_t batch_idx, int32_t* seq_lens,
                        int32_t* block_tables) {
  if (batch_idx < 0 || batch_idx >= a->batch) return;
  // Free EVERY valid row entry, not just ceil(len/bs): speculative
  // decoding rewinds seq_lens after rejecting drafted tokens, which can
  // leave reserved blocks beyond the rewound length — slicing by `used`
  // would leak them on release.
  int32_t* row =
      block_tables + static_cast<int64_t>(batch_idx) * a->max_blocks_per_seq;
  for (int32_t b = a->max_blocks_per_seq - 1; b >= 0; --b) {
    if (row[b] >= 0) a->free_stack[(*a->num_free)++] = row[b];
    row[b] = -1;
  }
  seq_lens[batch_idx] = 0;
}

}  // extern "C"
