// K1 and K2: the lane rANS encode and decode scans for Hopper (sm_90a).
//
// Replace the Pallas kernels of the JAX package:
//   K1 _enc_kernel (encode_scan_pallas_packed) in the JAX package's
//      ops/pallas_rans.py
//   K2 _dec_kernel (decode_scan_pallas), same file
// with the contract of the XLA scans they mirror (see lane_rans_step.cuh).
//
// Both run one thread per lane, the u32 state and the cursor/pointer in
// registers, a loop over the K steps inside the thread.  The operands are
// step-major (K, L), so the 32 lanes of a warp read 32 neighbouring words
// per step.  The Pallas kernels' one-hot matmul row lookup and 8-bit limb
// division exist only because the TPU lacks a gather and a u32 divide;
// here a lane gathers a prepared table entry (K1) or searches a compact
// row in shared memory (K2), and Hopper's own lack of an integer divide
// is met by a multiply with a precomputed magic (K1).
//
// Neither is bound by bytes (a few MB a launch) but by the per-lane chain
// of K dependent steps: with one chain a thread and 4096 lanes, a step's
// latency is the kernel's time.  Both run one warp a block, so 4096 lanes
// make 128 blocks on 132 SMs.
//
// K1 issues every memory read ahead of the state chain, which encode
// allows because a slot's table entry depends only on its operand, never
// on the state:
//   * the table is the prepared one of prepare_encode_table: one 16-byte
//     entry a (row, symbol), 4 KB a row, 1 MB for the combined 256-row
//     table (it stays in L2; no shared-memory copy);
//   * packed operands reach each lane through a cp.async ring in shared
//     memory kOpRing steps ahead; once step j's operand has landed, its
//     entry is requested into a second ring, kEncLead steps ahead.  One
//     commit group a step, and one cp.async.wait_group at the top of step
//     k finds the entry of step k + 1 and the operand of step k +
//     kEncLead + 1 landed.  Both are used a step later: the entry
//     unpacked (lr_enc_op), the operand turned into the address of the
//     next entry request, so neither a shared load nor an address holds
//     up the copies or the chain.  A skip slot's entry is the all-zero
//     identity, a zero-fill copy that reads nothing;
//   * the chain is a compare, a select, an exact division by a 48-bit
//     magic (a high multiply, a wide multiply-add, a shift) and a
//     multiply-add (lr_enc_lane_step), branch-free;
//   * a word leaves by a store no later instruction waits on, onto rows
//     the warp zeroed together, with 16-byte stores, while its first
//     copies were in flight (the 32 staging rows of a warp are one
//     block).  Zeroing only past each lane's last word, after the loop
//     and a row at a time, made a K = 0 launch take 0.0123 ms on an H100
//     against 0.0076 ms this way (tools/probe_lane_rans.py).
// What bounds K1 then is the issue of a step's ~55 instructions (the
// rings' bookkeeping and addresses are most of them) by one warp with its
// scheduler to itself: ~0.05 us a step on an H100, coded or skipped.
//
// K2 keeps every memory load off the chain from one step's state to the
// next, and the step free of branches but for the rare long search:
//   * the slice's compact table (784 B a row: 98 KB for RT's 128 rows,
//     200,704 B for DCVC-FM's 256-row y table, which with the rings'
//     ~4.2 KB leaves a block one SM to itself, under the 227 KB a block
//     may take) is copied into shared memory once a block by one bulk
//     copy (TMA, cp.async.bulk) that completes on an mbarrier, while the
//     lanes load their carry, first row ids and first refill words;
//   * the symbol search reads only shared memory (lr_find_sym_compact:
//     a bucket index, then the bucket's few u16 bins at once);
//   * row ids and refill words reach each lane through two rings in
//     shared memory, filled by cp.async kRing steps (rows) or kRing words
//     (words) ahead; every step issues one copy to each ring, commits one
//     group and moves the next row id and refill word into registers, so
//     the chain finds them there.  Rings, and not registers loaded from
//     global memory, because the scoreboard is per warp: a register that
//     a load fills a step ahead stalls the warp wherever it is read or
//     moved before the load lands;
//   * a skipped slot is a select, not a branch; symbols are stored and
//     never read back.
// What bounds K2 then is the issue of one step's instructions (about a
// hundred) by a warp that has its scheduler to itself, with nothing to
// fill the stalls:
// on an H100 a step takes ~0.15 us whether its slot is coded or skipped
// (tools/probe_lane_rans.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "lane_rans_step.cuh"

namespace {

constexpr int kEncThreads = 32;   // K1: one warp a block
constexpr int kOpRing = 64;       // K1: operands in flight, in steps
constexpr int kEncLead = 32;      // K1: entries requested this far ahead
constexpr int kDecThreads = 32;   // K2: one warp a block
constexpr int kRing = 16;         // K2: row ids and words in flight
constexpr int kMaxDecRows = LR_DEC_MAX_ROWS;
// K2's static shared memory: the two rings and the mbarrier
constexpr int kDecStaticSmem =
    (2 * kRing + 1) * kDecThreads * 4 + (int)sizeof(uint64_t);
static_assert(kMaxDecRows < LR_SKIP, "a row id must not be the sentinel");
static_assert(kMaxDecRows * LR_DEC_ROW_BYTES + kDecStaticSmem <= 232448,
              "K2's largest table and rings exceed a block's shared memory");

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of asynchronous copy.
__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase completes; traps (a launch error, not a hang) if a
// copy never lands.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// Bulk copy global -> shared on the TMA unit (16-byte aligned ends, size a
// multiple of 16), completing `bytes` on `bar`.
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4-byte cp.async; src_bytes 0 stores a zero word and reads nothing (src
// may then point anywhere).
__device__ inline void copy4_async(void* dst, const int32_t* src,
                                   uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 16-byte cp.async, L2 only (both ends 16-byte aligned); `zero` stores
// zeros and reads nothing (the ignore-src form: no source-size operand).
__device__ inline void copy16_async(void* dst, const uint32_t* src,
                                    bool zero) {
  asm volatile(
      "{\n"
      ".reg .pred z;\n"
      "setp.ne.b32 z, %2, 0;\n"
      "cp.async.cg.shared.global [%0], [%1], 16, z;\n"
      "}\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"((uint32_t)zero)
      : "memory");
}

__device__ inline void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A store under a predicate, not behind a branch; nothing in the kernel
// reads it back.
__device__ inline void store_if(bool p, int32_t* dst, uint32_t v) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %0, 0;\n"
      "@p st.global.b32 [%1], %2;\n"
      "}\n" ::"r"((uint32_t)p),
      "l"(dst), "r"(v));
}

__global__ void __launch_bounds__(kEncThreads)
    lr_encode_kernel(int K, int L, int nr, int mw,
                     const int32_t* __restrict__ packed,
                     const uint32_t* __restrict__ etab,
                     int32_t* __restrict__ staging,
                     int32_t* __restrict__ lens,
                     int64_t* __restrict__ states) {
  static_assert((kOpRing & (kOpRing - 1)) == 0 &&
                    (kEncLead & (kEncLead - 1)) == 0,
                "ring sizes are powers of two");
  // operand of step j at op_ring[j % kOpRing], entry of step j at
  // ent_ring[j % kEncLead]
  __shared__ int32_t op_ring[kOpRing][kEncThreads];
  __shared__ uint4 ent_ring[kEncLead][kEncThreads];
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kEncThreads + t;
  const bool live = lane < L;
  const int src = live ? lane : L - 1;  // a dead lane shadows the last one
  const uint32_t last = (uint32_t)nr - 1u;

  // Where the entry of step j with operand pk comes from: the all-zero
  // identity (a copy that reads nothing) for a skip slot, and for a step
  // past the last, whose operand slot holds zeros or a stale operand (left
  // to read, the zeros of every lane would all ask for one entry).
  const uint32_t* ent_src;
  bool ent_zero;
  auto locate_entry = [&](int j, int32_t pk) {
    ent_src = etab + lr_enc_entry_at(pk, last);
    ent_zero = lr_enc_is_skip(pk) || j >= K;
  };

  // operands past the last step are zeros, copied from nowhere (the
  // table stands in for a source address: `packed` may be empty)
  const int32_t* op_next = packed + src;  // operand of step k + kOpRing
  for (int j = 0; j < kOpRing; ++j, op_next += L)
    copy4_async(&op_ring[j][t], j < K ? op_next : (const int32_t*)etab,
                j < K ? 4u : 0u);
  async_commit();

  // While the operands travel, the warp zeroes its lanes' staging rows,
  // one contiguous block of words, together: int4 stores, then the last
  // words one at a time.  The block starts 16-byte aligned, since the
  // staging does (the wrapper allocates it) and a block's 32 rows span
  // 128 mw bytes.  The words the lanes emit land on top (the __syncwarp
  // orders the two), so the staging holds zeros past each lane's last
  // word.
  {
    const int rows = min(L - (int)blockIdx.x * kEncThreads, kEncThreads);
    int32_t* blk = staging + (int64_t)blockIdx.x * kEncThreads * mw;
    const int n = rows * mw;
    const int b = n & ~3;
#pragma unroll 1
    for (int c = 4 * t; c < b; c += 4 * kEncThreads)
      *(int4*)(blk + c) = make_int4(0, 0, 0, 0);
    if (b + t < n) blk[b + t] = 0;
    __syncwarp();
  }
  async_wait<0>();
  for (int j = 0; j < kEncLead; ++j) {
    locate_entry(j, op_ring[j][t]);
    copy16_async(&ent_ring[j][t], ent_src, ent_zero);
  }
  async_commit();
  async_wait<0>();
  uint4 e = ent_ring[0][t];
  LrEncOp op = lr_enc_op(e.x, e.y, e.z, e.w);
  locate_entry(kEncLead, op_ring[kEncLead][t]);

  // Ring invariant: at the top of step k, operands of steps [k + kEncLead
  // + 1, k + kOpRing) and entries of steps [k, k + kEncLead) are
  // requested, and the source of step k + kEncLead's entry is located.
  // Step k requests that entry into entry k's slot (read a step earlier)
  // and the operand of step k + kOpRing into operand k's (read kEncLead +
  // 1 steps earlier), commits one group, and reads the entry of step k + 1
  // and the operand of step k + kEncLead + 1.  Those were requested by
  // steps k + 1 - kEncLead and k + kEncLead + 1 - kOpRing: waiting for all
  // but the newest kEncLead - 2 groups finds both landed (kOpRing >= 2
  // kEncLead).  What a step reads is used a step later, so no shared load
  // and no address computation holds up the copies or the chain.
  static_assert(kOpRing >= 2 * kEncLead, "operand lead too short");
  uint32_t state = 1u << 16;
  int32_t cur = 0;
  int32_t* out = staging + (int64_t)src * mw;
  const int32_t room = live ? mw : 0;  // a dead lane stores nothing
  int k = 0;
  auto step = [&](bool more) {
    async_wait<kEncLead - 2>();
    e = ent_ring[(k + 1) & (kEncLead - 1)][t];
    const int32_t pk = op_ring[(k + kEncLead + 1) & (kOpRing - 1)][t];
    copy16_async(&ent_ring[k & (kEncLead - 1)][t], ent_src, ent_zero);
    if (more) copy4_async(&op_ring[k & (kOpRing - 1)][t], op_next, 4u);
    async_commit();

    const int32_t slot = cur;
    uint32_t word;
    const bool emit = lr_enc_lane_step(op, &state, &cur, &word);
    store_if(emit & (slot < room), out + (uint32_t)slot, word);
    op = lr_enc_op(e.x, e.y, e.z, e.w);
    locate_entry(more ? 0 : k + kEncLead + 1, pk);
    op_next += L;
    ++k;
  };
  while (k < K - kOpRing) step(true);
  while (k < K) step(false);
  if (live) {
    lens[lane] = cur;
    states[lane] = (int64_t)state;
  }
  async_wait<0>();  // the rings' last copies land before the block ends
}

__global__ void __launch_bounds__(kDecThreads)
    lr_decode_kernel(int K, int L, int nr, int mw,
                     const int32_t* __restrict__ data,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ dtab,
                     const int64_t* __restrict__ state_in,
                     const int32_t* __restrict__ ptr_in,
                     int32_t* __restrict__ syms,
                     int64_t* __restrict__ state_out,
                     int32_t* __restrict__ ptr_out) {
  extern __shared__ __align__(128) uint8_t tab[];  // nr compact rows
  // row id of step k at row_ring[k % kRing], word q at word_ring[q % kRing];
  // word_ring[kRing] takes the empty copy of a lane that did not refill
  __shared__ int32_t row_ring[kRing][kDecThreads];
  __shared__ uint32_t word_ring[kRing + 1][kDecThreads];
  __shared__ __align__(8) uint64_t tab_full;
  const int t = threadIdx.x;
  const int lane = blockIdx.x * kDecThreads + t;
  const bool live = lane < L;
  const int src = live ? lane : L - 1;  // a dead lane shadows the last one

  if (t == 0) mbar_init(&tab_full, 1);
  __syncthreads();
  if (t == 0) {
    uint32_t bytes = (uint32_t)nr * LR_DEC_ROW_BYTES;
    mbar_arrive_expect_tx(&tab_full, bytes);
    bulk_load(tab, dtab, bytes, &tab_full);
  }

  // while the table lands: the carry, the first row ids, the first words
  uint32_t state = (uint32_t)state_in[src];
  int32_t ptr = ptr_in[src];
  const int32_t* words = data + (int64_t)src * mw;
  const int32_t* row_next = rows + src;  // row id of step k + kRing
  int32_t* sym_out = syms + lane;
  for (int k = 0; k < kRing; ++k, row_next += L)
    copy4_async(&row_ring[k][t], k < K ? row_next : rows, k < K ? 4u : 0u);
  for (int j = 0; j < kRing; ++j) {
    // a word past either end of the lane's row reads as 0
    int32_t q = ptr + j;
    bool ok = q >= 0 && q < mw;
    copy4_async(&word_ring[q & (kRing - 1)][t], ok ? words + q : words,
                ok ? 4u : 0u);
  }
  async_commit();
  async_wait<0>();
  int row = row_ring[0][t];
  mbar_wait(&tab_full, 0);

  // Ring invariant: row ids of steps [k, k + kRing) and words [ptr, ptr +
  // kRing) are requested.  Step k requests row k + kRing into row k's slot
  // and, if it refills, word ptr + kRing into word ptr's slot, and commits
  // one group.  A step consumes one row and at most one word, so at the
  // top of step k the next row was requested by step k + 1 - kRing and
  // the current word by step k - kRing or earlier: waiting for all but
  // the newest kRing - 2 groups finds both landed, and reading them there
  // keeps both reads off the state chain.
  auto step = [&](int k, bool more) {
    async_wait<kRing - 2>();
    const int next_row = row_ring[(k + 1) & (kRing - 1)][t];
    const uint32_t word = word_ring[ptr & (kRing - 1)][t];
    if (more) copy4_async(&row_ring[k & (kRing - 1)][t], row_next, 4u);

    const int32_t p = ptr;
    const int sym = lr_dec_lane_step(tab, nr, row, word, &state, &ptr);
    const bool refill = ptr != p;

    const int32_t q = p + kRing;  // a word past either end reads as 0
    const bool fetch = refill && (uint32_t)q < (uint32_t)mw;
    copy4_async(&word_ring[refill ? p & (kRing - 1) : kRing][t], words + q,
                fetch ? 4u : 0u);
    async_commit();
    if (live) *sym_out = sym;
    row = next_row;
    row_next += L;
    sym_out += L;
  };
  int k = 0;
  for (; k < K - kRing; ++k) step(k, true);
  for (; k < K; ++k) step(k, false);
  if (live) {
    state_out[lane] = (int64_t)state;
    ptr_out[lane] = ptr;
  }
  async_wait<0>();  // the rings' last copies land before the block ends
}

}  // namespace

// Launch on `stream` and return cudaGetLastError() (0 on success).
// etab: nr prepared encode rows (16-byte aligned), 1 <= nr <= LR_SKIP;
// staging: (L, mw) words, 16-byte aligned.
extern "C" int lr_encode_launch(const void* packed, const void* etab,
                                void* staging, void* lens, void* states,
                                int K, int L, int nr, int mw, void* stream) {
  if (nr < 1 || nr > LR_SKIP || (uintptr_t)staging % 16)
    return (int)cudaErrorInvalidValue;
  int blocks = (L + kEncThreads - 1) / kEncThreads;
  lr_encode_kernel<<<blocks, kEncThreads, 0, (cudaStream_t)stream>>>(
      K, L, nr, mw, (const int32_t*)packed, (const uint32_t*)etab,
      (int32_t*)staging, (int32_t*)lens, (int64_t*)states);
  return (int)cudaGetLastError();
}

// dtab: nr compact rows (16-byte aligned), 1 <= nr <= kMaxDecRows.
extern "C" int lr_decode_launch(const void* data, const void* rows,
                                const void* dtab, const void* state_in,
                                const void* ptr_in, void* syms,
                                void* state_out, void* ptr_out, int K,
                                int L, int nr, int mw, void* stream) {
  if (nr < 1 || nr > kMaxDecRows) return (int)cudaErrorInvalidValue;
  // allow the largest table once per device, not on every launch
  static bool smem_allowed[64];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(lr_decode_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDecRows * LR_DEC_ROW_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_allowed[dev] = true;
  }
  int smem = nr * LR_DEC_ROW_BYTES;
  int blocks = (L + kDecThreads - 1) / kDecThreads;
  lr_decode_kernel<<<blocks, kDecThreads, smem, (cudaStream_t)stream>>>(
      K, L, nr, mw, (const int32_t*)data, (const int32_t*)rows,
      (const int32_t*)dtab, (const int64_t*)state_in,
      (const int32_t*)ptr_in, (int32_t*)syms, (int64_t*)state_out,
      (int32_t*)ptr_out);
  return (int)cudaGetLastError();
}
