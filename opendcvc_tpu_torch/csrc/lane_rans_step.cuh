// Lane rANS encode/decode, one lane at a time: the arithmetic shared by the
// CUDA kernels (lane_rans.cu) and the host shim the CPU tests build with
// g++ (lane_rans_host.cpp defines __host__/__device__ away).
//
// Contract (bit for bit the XLA scans of the JAX package,
// entropy/device_rans.py _encode_scan_carry / _decode_scan_carry):
//   * every table row holds 257 cumulative bins over symbols -128..127,
//     cum[0] = 0, cum[256] = 65536, every frequency >= 1;
//   * the state lives in [2^16, 2^32) with 16-bit renormalisation, so a
//     step moves at most one u16 word;
//   * encode: if state >= freq << 16, emit state & 0xFFFF at the lane's
//     cursor and shift; then state = (state / freq) << 16
//     + state % freq + start.  Words past mw are dropped but the cursor
//     still counts them (the regrow ladder reads the overflow from it);
//   * decode: f = state & 0xFFFF, symbol = last bin with cum <= f,
//     state = freq * (state >> 16) + f - start; if state < 2^16 pull
//     data[ptr++] (a read past the end gives 0);
//   * the skip sentinel row is a zero-rate passthrough: no emission, no
//     state change, decoded as 0.
// Row ids at or above the table's row count (other than the sentinel) are
// clamped to its last row, so a bad operand cannot read outside the table.
#pragma once

#include <stdint.h>

#define LR_ENC_ROW_BITS 9
#define LR_ENC_ROW_MASK 511
#define LR_ENC_SKIP 511  // 9-bit: combined encode tables reach 256 rows
#define LR_DEC_SKIP 255  // decode tables stay below 255 rows
#define LR_BINS 257

// One encode step.  *emit is set when the low 16 bits of the incoming
// state leave the lane (the caller stores them before the call).
__host__ __device__ inline uint32_t lr_enc_step(uint32_t state,
                                                uint32_t start,
                                                uint32_t freq, int* emit) {
  *emit = state >= (freq << 16);
  if (*emit) state >>= 16;
  return ((state / freq) << 16) + state % freq + start;
}

// Last bin s in [0, 255] with cum[s] <= f (rows strictly increase).
__host__ __device__ inline int lr_find_sym(const int32_t* cum, uint32_t f) {
  int lo = 0, hi = 256;  // invariant: cum[lo] <= f < cum[hi]
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if ((uint32_t)cum[mid] <= f) lo = mid; else hi = mid;
  }
  return lo;
}

// One decode step before the refill: freq * (state >> 16) + f - start.
__host__ __device__ inline uint32_t lr_dec_step(uint32_t state,
                                                uint32_t start,
                                                uint32_t freq) {
  return freq * (state >> 16) + (state & 0xFFFFu) - start;
}

// Encode lane `lane` over all K steps from a fresh carry (state 2^16,
// cursor 0).  packed (K, L): (sym + 128) << 9 | row, step-major;
// table (nr, 257); staging (L, mw) receives the words in emit order and
// zeros past the lane's last word; lens (L,); states (L,) as int64.
__host__ __device__ inline void lr_encode_lane(
    int lane, int K, int L, int nr, int mw, const int32_t* packed,
    const int32_t* table, int32_t* staging, int32_t* lens,
    int64_t* states) {
  uint32_t state = 1u << 16;
  int32_t cur = 0;
  int32_t* out = staging + (int64_t)lane * mw;
  for (int k = 0; k < K; ++k) {
    int32_t pk = packed[(int64_t)k * L + lane];
    int row = pk & LR_ENC_ROW_MASK;
    if (row == LR_ENC_SKIP) continue;
    if (row >= nr) row = nr - 1;
    int sym = (pk >> LR_ENC_ROW_BITS) & 255;
    const int32_t* cum = table + (int64_t)row * LR_BINS;
    uint32_t start = (uint32_t)cum[sym];
    uint32_t freq = (uint32_t)(cum[sym + 1] - cum[sym]);
    if (freq < 1u) freq = 1u;
    uint32_t word = state & 0xFFFFu;
    int emit;
    state = lr_enc_step(state, start, freq, &emit);
    if (emit) {
      if (cur < mw) out[cur] = (int32_t)word;
      ++cur;
    }
  }
  for (int c = cur; c < mw; ++c) out[c] = 0;
  lens[lane] = cur;
  states[lane] = (int64_t)state;
}

// Decode lane `lane` over K steps, continuing the carry (state, ptr).
// data (L, mw) u16 words in decode order (int32); rows (K, L) local row
// ids or LR_DEC_SKIP, step-major; syms (K, L) receives symbols in
// [-128, 127].
__host__ __device__ inline void lr_decode_lane(
    int lane, int K, int L, int nr, int mw, const int32_t* data,
    const int32_t* rows, const int32_t* table, const int64_t* state_in,
    const int32_t* ptr_in, int32_t* syms, int64_t* state_out,
    int32_t* ptr_out) {
  uint32_t state = (uint32_t)state_in[lane];
  int32_t ptr = ptr_in[lane];
  const int32_t* words = data + (int64_t)lane * mw;
  for (int k = 0; k < K; ++k) {
    int64_t at = (int64_t)k * L + lane;
    int row = rows[at];
    if (row == LR_DEC_SKIP) {
      syms[at] = 0;
      continue;
    }
    if (row >= nr) row = nr - 1;
    const int32_t* cum = table + (int64_t)row * LR_BINS;
    int s = lr_find_sym(cum, state & 0xFFFFu);
    uint32_t start = (uint32_t)cum[s];
    uint32_t freq = (uint32_t)(cum[s + 1] - cum[s]);
    state = lr_dec_step(state, start, freq);
    if (state < (1u << 16)) {
      uint32_t w = (ptr >= 0 && ptr < mw) ? (uint32_t)words[ptr] : 0u;
      state = (state << 16) | w;
      ++ptr;
    }
    syms[at] = s - 128;
  }
  state_out[lane] = (int64_t)state;
  ptr_out[lane] = ptr;
}
