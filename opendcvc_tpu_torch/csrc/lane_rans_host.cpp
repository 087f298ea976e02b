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

extern "C" void lr_decode_host(const int32_t* data, const int32_t* rows,
                               const int32_t* table, const int64_t* state_in,
                               const int32_t* ptr_in, int32_t* syms,
                               int64_t* state_out, int32_t* ptr_out, int K,
                               int L, int nr, int mw) {
  for (int lane = 0; lane < L; ++lane)
    lr_decode_lane(lane, K, L, nr, mw, data, rows, table, state_in, ptr_in,
                   syms, state_out, ptr_out);
}
