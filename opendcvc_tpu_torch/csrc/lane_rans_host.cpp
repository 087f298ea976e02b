// Host build of the lane rANS step header: the CUDA kernels' per-lane
// arithmetic, compiled with g++ so the CPU tests can hold it against the
// plain PyTorch versions without a GPU.
#define __host__
#define __device__

#include "lane_rans_step.cuh"

extern "C" void lr_encode_host(const int32_t* packed, const int32_t* table,
                               int32_t* staging, int32_t* lens,
                               int64_t* states, int K, int L, int nr,
                               int mw) {
  for (int lane = 0; lane < L; ++lane)
    lr_encode_lane(lane, K, L, nr, mw, packed, table, staging, lens, states);
}

// K2, one lane after another, on the compact table `dtab` (nr rows of
// LR_DEC_ROW_BYTES): the kernel's own step (lr_dec_lane_step), which the
// kernel runs with the table in shared memory and the words prefetched.
extern "C" void lr_decode_host(const int32_t* data, const int32_t* rows,
                               const int32_t* dtab, const int64_t* state_in,
                               const int32_t* ptr_in, int32_t* syms,
                               int64_t* state_out, int32_t* ptr_out, int K,
                               int L, int nr, int mw) {
  const uint8_t* tab = (const uint8_t*)dtab;
  for (int lane = 0; lane < L; ++lane) {
    uint32_t state = (uint32_t)state_in[lane];
    int32_t ptr = ptr_in[lane];
    const int32_t* words = data + (int64_t)lane * mw;
    for (int k = 0; k < K; ++k) {
      int64_t at = (int64_t)k * L + lane;
      uint32_t word = (ptr >= 0 && ptr < mw) ? (uint32_t)words[ptr] : 0u;
      syms[at] = lr_dec_lane_step(tab, nr, rows[at], word, &state, &ptr);
    }
    state_out[lane] = (int64_t)state;
    ptr_out[lane] = ptr;
  }
}

// The compact lookup for every slot value f of every row: sym, start and
// next (nr, 65536) each.
extern "C" void lr_lookup_host(const int32_t* dtab, int nr, int32_t* sym,
                               int32_t* start, int32_t* next) {
  const uint8_t* tab = (const uint8_t*)dtab;
  for (int r = 0; r < nr; ++r) {
    for (uint32_t f = 0; f < 65536u; ++f) {
      int64_t at = (int64_t)r * 65536 + f;
      uint32_t s0, freq;
      sym[at] = lr_find_sym_compact(tab + (int64_t)r * LR_DEC_ROW_BYTES, f,
                                    &s0, &freq);
      start[at] = (int32_t)s0;
      next[at] = (int32_t)(s0 + freq);
    }
  }
}
