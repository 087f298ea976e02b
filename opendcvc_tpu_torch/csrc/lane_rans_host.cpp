// Host build of the lane rANS step header: the CUDA kernels' per-lane
// arithmetic, compiled with g++ so the CPU tests can hold it against the
// plain PyTorch versions without a GPU.
#define __host__
#define __device__

#include "lane_rans_step.cuh"

// K1, one lane after another, on the prepared table `etab` (nr rows of
// LR_ENC_ROW_WORDS): the kernel's own entry lookup and step
// (lr_enc_entry_at, lr_enc_op, lr_enc_lane_step), which the kernel runs
// with the operands and entries prefetched; a skip slot reads the
// all-zero entry, as the kernel's zero-fill copy gives it.
extern "C" void lr_encode_host(const int32_t* packed, const int32_t* etab,
                               int32_t* staging, int32_t* lens,
                               int64_t* states, int K, int L, int nr,
                               int mw) {
  const uint32_t* tab = (const uint32_t*)etab;
  const uint32_t zero[LR_ENC_ENTRY_WORDS] = {0u, 0u, 0u, 0u};
  for (int lane = 0; lane < L; ++lane) {
    uint32_t state = 1u << 16;
    int32_t cur = 0;
    int32_t* out = staging + (int64_t)lane * mw;
    for (int k = 0; k < K; ++k) {
      const int32_t pk = packed[(int64_t)k * L + lane];
      const uint32_t* e = lr_enc_is_skip(pk)
                              ? zero
                              : tab + lr_enc_entry_at(pk, (uint32_t)nr - 1u);
      const LrEncOp op = lr_enc_op(e[0], e[1], e[2], e[3]);
      const int32_t slot = cur;
      uint32_t word;
      if (lr_enc_lane_step(op, &state, &cur, &word) && slot < mw)
        out[slot] = (int32_t)word;
    }
    for (int c = cur < mw ? cur : mw; c < mw; ++c) out[c] = 0;
    lens[lane] = cur;
    states[lane] = (int64_t)state;
  }
}

// q[i] = x[i] / d[i] and r[i] = x[i] % d[i] by K1's exact division, from
// the words ml[i], mh[i] of d's magic (ops/lane_rans.py div_magic).
extern "C" void lr_divmod_host(const uint32_t* d, const uint32_t* ml,
                               const uint32_t* mh, const uint32_t* x,
                               int64_t n, uint32_t* q, uint32_t* r) {
  for (int64_t i = 0; i < n; ++i) {
    q[i] = lr_div_exact(x[i], ml[i], mh[i]);
    r[i] = x[i] - q[i] * d[i];
  }
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
