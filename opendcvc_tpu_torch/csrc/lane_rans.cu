// K1 and K2: the lane rANS encode and decode scans for Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package:
//   K1 _enc_kernel (encode_scan_pallas_packed) in the JAX package's
//      ops/pallas_rans.py
//   K2 _dec_kernel (decode_scan_pallas), same file
// with the contract of the XLA scans they mirror (see lane_rans_step.cuh).
//
// Design: one thread per lane, the u32 state and the cursor/pointer in
// registers, a loop over the K steps inside the thread.  The operands are
// step-major (K, L), so the 32 lanes of a warp read 32 neighbouring words
// per step.  The Pallas kernels' one-hot matmul row lookup and 8-bit limb
// division exist only because the TPU lacks a gather and a u32 divide;
// here a lane reads its two cumulative bins directly (K1) or
// binary-searches its row (K2), and divides in u32.
//
// Tables: the int32 (nr, 257) rows are read through L1/L2, not staged in
// shared memory.  K1's combined table (256 rows, 263 KB) would not fit a
// block's 227 KB as int32; it fits L2 (50 MB) many times over, and each
// step touches only two bins of one row per lane.
//
// Bound on this card: the per-lane chain of K dependent steps (a u32
// divide and two table reads per step), not memory: the bytes the scans
// must move are a few MB.  At 4096 lanes, 128 threads a block gives 32
// blocks on 132 SMs; filling the card (more lanes, or several threads a
// lane) is left for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_rans_step.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void lr_encode_kernel(int K, int L, int nr, int mw,
                                 const int32_t* __restrict__ packed,
                                 const int32_t* __restrict__ table,
                                 int32_t* __restrict__ staging,
                                 int32_t* __restrict__ lens,
                                 int64_t* __restrict__ states) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L)
    lr_encode_lane(lane, K, L, nr, mw, packed, table, staging, lens, states);
}

__global__ void lr_decode_kernel(int K, int L, int nr, int mw,
                                 const int32_t* __restrict__ data,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ table,
                                 const int64_t* __restrict__ state_in,
                                 const int32_t* __restrict__ ptr_in,
                                 int32_t* __restrict__ syms,
                                 int64_t* __restrict__ state_out,
                                 int32_t* __restrict__ ptr_out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane < L)
    lr_decode_lane(lane, K, L, nr, mw, data, rows, table, state_in, ptr_in,
                   syms, state_out, ptr_out);
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).
extern "C" int lr_encode_launch(const void* packed, const void* table,
                                void* staging, void* lens, void* states,
                                int K, int L, int nr, int mw, void* stream) {
  int blocks = (L + kThreads - 1) / kThreads;
  lr_encode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      K, L, nr, mw, (const int32_t*)packed, (const int32_t*)table,
      (int32_t*)staging, (int32_t*)lens, (int64_t*)states);
  return (int)cudaGetLastError();
}

extern "C" int lr_decode_launch(const void* data, const void* rows,
                                const void* table, const void* state_in,
                                const void* ptr_in, void* syms,
                                void* state_out, void* ptr_out, int K,
                                int L, int nr, int mw, void* stream) {
  int blocks = (L + kThreads - 1) / kThreads;
  lr_decode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      K, L, nr, mw, (const int32_t*)data, (const int32_t*)rows,
      (const int32_t*)table, (const int64_t*)state_in,
      (const int32_t*)ptr_in, (int32_t*)syms, (int64_t*)state_out,
      (int32_t*)ptr_out);
  return (int)cudaGetLastError();
}
