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
//
// Decode reads the compact rows of ops/lane_rans.py prepare_decode_table:
// LR_DEC_ROW_BYTES a row, u16 bins[s] = cum[s] - 1 mod 2^16 for s in [0,
// 256) (bins[0] = 0xFFFF for cum[0] = 0 pads the 255 inner bins), 16 bytes
// of 0xFF (bins[256..263]: cum[256] - 1, and room for bins[s + j] reads),
// then u8 bucket[b] at LR_DEC_BUCKET_OFF = the last s with cum[s] <= b << 8.
// The 784-byte stride also puts the same bin of neighbouring rows in
// different shared-memory banks.
#pragma once

#include <stdint.h>

#define LR_ENC_ROW_BITS 9
#define LR_ENC_ROW_MASK 511
#define LR_ENC_SKIP 511  // 9-bit: combined encode tables reach 256 rows
#define LR_DEC_SKIP 255  // decode tables stay below 255 rows
#define LR_BINS 257
#define LR_DEC_ROW_BYTES 784
#define LR_DEC_BUCKET_OFF 528
#define LR_DEC_SCAN 5  // bucket ranges up to this many symbols: one read

// One encode step.  *emit is set when the low 16 bits of the incoming
// state leave the lane (the caller stores them before the call).
__host__ __device__ inline uint32_t lr_enc_step(uint32_t state,
                                                uint32_t start,
                                                uint32_t freq, int* emit) {
  *emit = state >= (freq << 16);
  if (*emit) state >>= 16;
  return ((state / freq) << 16) + state % freq + start;
}

// The bin s in [lo, lo + LR_DEC_SCAN) with cum[s] <= f < cum[s + 1] on a
// compact row, from bins lo .. lo + LR_DEC_SCAN read at once; *start =
// cum[s], *freq = cum[s + 1] - cum[s].  The bins hold cum - 1 mod 2^16, so
// cum[lo + j] <= f reads bins[lo + j] < f for j >= 1, and the 0xFFFF
// padding past bin 255 (cum[256] - 1) is never below f.  Those compares
// hold for a prefix of j, so two levels of selects pick the two bins.
__host__ __device__ inline int lr_scan_bins(const uint16_t* bins, int lo,
                                            uint32_t f, uint32_t* start,
                                            uint32_t* freq) {
  static_assert(LR_DEC_SCAN == 5, "the selects below pick among five");
  const uint16_t* at = bins + lo;
  uint32_t c[LR_DEC_SCAN + 1];
#pragma unroll
  for (int j = 0; j <= LR_DEC_SCAN; ++j) c[j] = at[j];
#ifdef __CUDA_ARCH__
  // All six reads issue before the compares: left alone, ptxas puts the
  // read of a bin only one select uses under that select's predicate, a
  // second dependent shared read on the chain.
#pragma unroll
  for (int j = 0; j <= LR_DEC_SCAN; ++j) asm volatile("" : "+r"(c[j]));
#endif
  const bool le1 = c[1] < f, le2 = c[2] < f, le3 = c[3] < f, le4 = c[4] < f;
  uint32_t c0 = le2 ? (le3 ? c[3] : c[2]) : (le1 ? c[1] : c[0]);
  uint32_t c1 = le2 ? (le3 ? c[4] : c[3]) : (le1 ? c[2] : c[1]);
  if (le4) {
    c0 = c[4];
    c1 = c[5];
  }
  *start = (c0 + 1u) & 0xFFFFu;
  *freq = (c1 - c0) & 0xFFFFu;
  return lo + le1 + le2 + le3 + le4;
}

// Last bin s in [0, 255] with cum[s] <= f on a compact row, with its
// start and frequency.  f's bucket b = f >> 8 bounds s to [bucket[b],
// bucket[b + 1]] (to 255 in the last bucket).  A range of up to
// LR_DEC_SCAN symbols (all of a Gaussian row's bulk) costs two dependent
// reads, the bucket's and the bins', and no branch; a wider one (a row's
// tail) is halved down to that first.
__host__ __device__ inline int lr_find_sym_compact(const uint8_t* row,
                                                   uint32_t f,
                                                   uint32_t* start,
                                                   uint32_t* freq) {
  const uint16_t* bins = (const uint16_t*)row;
  const uint8_t* bucket = row + LR_DEC_BUCKET_OFF;
  const uint32_t b = f >> 8;
  // invariant: cum[lo] <= f < cum[hi]
  int lo = bucket[b];
  int hi = bucket[(b + 1u) & 255u] + 1;
  if (b == 255u) hi = 256;
  int s = lr_scan_bins(bins, lo, f, start, freq);
  if (hi - lo > LR_DEC_SCAN) {
    do {
      // an eight-way step: bins lo + q, ..., lo + 7q read at once (past hi
      // they compare false, padding included), so a bucket of up to 256
      // symbols narrows to a scan in two rounds
      const int q = (hi - lo + 7) >> 3;
      int n = 0;
#pragma unroll
      for (int i = 1; i < 8; ++i) n += bins[lo + q * i] < f;
      lo += q * n;
      if (lo + q < hi) hi = lo + q;
    } while (hi - lo > LR_DEC_SCAN);
    s = lr_scan_bins(bins, lo, f, start, freq);
  }
  return s;
}

// One decode step before the refill: freq * (state >> 16) + f - start.
__host__ __device__ inline uint32_t lr_dec_step(uint32_t state,
                                                uint32_t start,
                                                uint32_t freq) {
  return freq * (state >> 16) + (state & 0xFFFFu) - start;
}

// One step of K2's contract for one lane on the compact table `tab` (nr
// rows): the skip row keeps the state and decodes 0, a row id at or past
// nr is clamped to the last row, and a state that falls below 2^16 pulls
// `word` and advances *ptr.  `word` is data[*ptr] (0 past either end of
// the lane's row), read before the state asks for it.  Branch-free: a
// skipped slot still searches the clamped row and discards the result.
// Returns the symbol in [-128, 127].
__host__ __device__ inline int lr_dec_lane_step(const uint8_t* tab, int nr,
                                                int row, uint32_t word,
                                                uint32_t* state,
                                                int32_t* ptr) {
  const bool skip = row == LR_DEC_SKIP;
  const uint32_t last = (uint32_t)nr - 1u;
  const uint32_t r = (uint32_t)row < last ? (uint32_t)row : last;
  uint32_t start, freq;
  const int s = lr_find_sym_compact(tab + r * LR_DEC_ROW_BYTES,
                                    *state & 0xFFFFu, &start, &freq);
  const uint32_t decoded = lr_dec_step(*state, start, freq);
  const bool refill = !skip && decoded < (1u << 16);
  if (!skip) *state = refill ? (decoded << 16) | word : decoded;
  *ptr += refill;
  return skip ? 0 : s - 128;
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
