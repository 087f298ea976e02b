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
//   * the skip sentinel row (LR_SKIP) is a zero-rate passthrough: no
//     emission, no state change, decoded as 0.  Unlike the JAX package's
//     row 255, it lies outside every table, so a 256-row table codes its
//     row 255 like any other.
// Row ids at or above the table's row count (other than the sentinel) are
// clamped to its last row, so a bad operand cannot read outside the table.
//
// Encode reads the rows of ops/lane_rans.py prepare_encode_table:
// LR_ENC_ROW_WORDS u32 words a row, for each symbol the 16-byte entry
// {c16, ml, mh, start}: c16 = (2^16 - freq) << 16, ml and mh the low and
// high words of the magic M = ceil(2^48 / freq) of an exact division by
// freq (lr_div_exact), start = cum[s].  The all-zero entry stands for a
// skip slot: 2^16 - freq = 0 and start = 0 make the step an identity (see
// lr_enc_lane_step), so a skip needs neither a branch nor a select.
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
// The skip row id of both kernels, 9 bits wide: K1's combined per-frame
// tables reach 384 rows and K2's slices 256 (DCVC-FM's Laplace y table),
// so an 8-bit sentinel would collide with a coded row.  (The JAX package's
// streams mark a skip with row 255; the port's callers map it.)
#define LR_SKIP 511
#define LR_DEC_MAX_ROWS 256  // K2's shared-memory table: 256 x 784 B
#define LR_ENC_ENTRY_WORDS 4
#define LR_ENC_ROW_WORDS 1024  // 256 entries
#define LR_DEC_ROW_BYTES 784
#define LR_DEC_BUCKET_OFF 528
#define LR_DEC_SCAN 5  // bucket ranges up to this many symbols: one read

__host__ __device__ inline uint32_t lr_umulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// floor(x / d) for every u32 x and d in [1, 2^16], from d's magic M =
// ceil(2^48 / d) = mh 2^32 + ml (mh <= 2^16), with no divide instruction.
// Exact: M d = 2^48 + e with 0 <= e < d.  For x = q d + r, 0 <= r < d:
// x M / 2^48 = x / d + x e / (d 2^48), where 0 <= x e / (d 2^48) <
// 2^32 d / (d 2^48) = 2^-16 <= 1 / d, so q <= x / d <= x M / 2^48 <
// q + (r + 1) / d <= q + 1, and the floor of x M / 2^48 is q.  It is
// computed as floor(x M / 2^32) >> 16, where floor(x M / 2^32) = x mh +
// umulhi(x, ml) (x mh is an integer) lies below 2^49.  The magic of
// ops/lane_rans.py div_magic; the CPU tests check q at every quotient
// boundary of a sample of d.
__host__ __device__ inline uint32_t lr_div_exact(uint32_t x, uint32_t ml,
                                                 uint32_t mh) {
  return (uint32_t)(((uint64_t)x * mh + lr_umulhi(x, ml)) >> 16);
}

// What the encode chain needs of one slot, unpacked from its prepared
// entry before the state reaches it.
struct LrEncOp {
  uint32_t emit_above;  // freq * 2^16 - 1: a state above it emits a word
  uint32_t ml, mh;      // the magic of freq
  uint32_t comp;        // 2^16 - freq
  uint32_t start;
};

__host__ __device__ inline LrEncOp lr_enc_op(uint32_t c16, uint32_t ml,
                                             uint32_t mh, uint32_t start) {
  LrEncOp op;
  op.emit_above = ~c16;  // 2^32 - 1 - (2^16 - freq) 2^16
  op.ml = ml;
  op.mh = mh;
  op.comp = c16 >> 16;
  op.start = start;
  return op;
}

__host__ __device__ inline bool lr_enc_is_skip(int32_t pk) {
  return ((uint32_t)pk & LR_ENC_ROW_MASK) == LR_SKIP;
}

// Word offset of the prepared entry of packed operand pk in a table whose
// last row is `last` (a row id past it, the skip row's included, clamps
// to it): always inside the table.
__host__ __device__ inline uint32_t lr_enc_entry_at(int32_t pk,
                                                    uint32_t last) {
  const uint32_t row = (uint32_t)pk & LR_ENC_ROW_MASK;
  const uint32_t sym = ((uint32_t)pk >> LR_ENC_ROW_BITS) & 255u;
  return (row < last ? row : last) * LR_ENC_ROW_WORDS +
         sym * LR_ENC_ENTRY_WORDS;
}

// One encode step of one lane: if the state is at least freq << 16, its
// low 16 bits leave as *word at slot *cur (returns true, *cur advances)
// and it shifts right by 16; then state = (x / freq) << 16 + x % freq +
// start, computed as x + q (2^16 - freq) + start with q = x / freq from
// the magic: the same value, since x = q freq + x % freq, and below 2^32
// (q < 2^16 because x < freq << 16, and x % freq + start < 2^16).  On the
// all-zero skip entry nothing is emitted (no u32 is above 2^32 - 1) and
// the state stays: its 2^16 - freq and start are 0.  The state chain is a
// compare, a select, the division's high multiply, wide multiply-add and
// shift, and one multiply-add; everything of `op` is ready before it.
__host__ __device__ inline bool lr_enc_lane_step(const LrEncOp& op,
                                                 uint32_t* state,
                                                 int32_t* cur,
                                                 uint32_t* word) {
  const uint32_t s = *state;
  const bool emit = s > op.emit_above;
  *word = s & 0xFFFFu;
  const uint32_t x = emit ? s >> 16 : s;
  *state = lr_div_exact(x, op.ml, op.mh) * op.comp + (x + op.start);
  *cur += emit;
  return emit;
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
  const bool skip = row == LR_SKIP;
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
