// opendcvc_tpu native entropy-coding runtime (the host coder of the
// PyTorch port: the JAX package's native/rans.cpp, with the decoder bounded
// by the stream's end and a whole-stream check, rve_dec_check_end; the
// bytes it writes are unchanged).
//
// A fresh C++ implementation of byte-aligned rANS coding with the stream
// format used by the DCVC family of codecs (see reference semantics in
// the DCVC sources' src/cpp/py_rans/: SCALE_BITS=16 probabilities, state
// lower bound 1<<23 with byte renormalization, 2-bit bypass escape coding
// for out-of-range symbols, deferred reverse-order encoding, optional
// dual-coder stream packing).  Exposed through a plain C API for ctypes.
//
// Improvements over the reference design:
//   * O(1) symbol resolution in the decoder via an optional 2^16-entry
//     lookup table per CDF (the reference does a linear CDF scan per
//     symbol, rans.cpp:362-365).
//   * Interleaved (NHWC) channel-index mode for z-plane coding so the
//     device never has to transpose to planar before D2H.
//   * Generalized symbol split for N coders (N=1,2 wired today).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread rans.cpp -o librans_tpu.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <list>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kScaleBits = 16;
constexpr int kShiftBits = 23;
constexpr uint32_t kLowBound = 1u << kShiftBits;
constexpr int kEncRenormShift = kShiftBits - kScaleBits + 8;
constexpr uint32_t kDecMask = (1u << kScaleBits) - 1;
constexpr uint32_t kBypassBits = 2;
constexpr uint32_t kMaxBypassVal = (1u << kBypassBits) - 1;
// an int8 symbol's escape takes at most 5 two-bit groups; more than 15
// (30 bits) only a corrupt stream holds, and the cap keeps the escape's
// value arithmetic inside int32
constexpr int32_t kMaxBypassCount = 15;
// two coders' streams share at most this many identical tail bytes
constexpr int kMaxSharedTail = 8;

using RansState = uint32_t;

inline void enc_init(RansState& s) { s = kLowBound; }

inline void enc_renorm(RansState& s, uint8_t*& p, uint32_t freq) {
  const uint32_t x_max = freq << kEncRenormShift;
  while (s >= x_max) {
    *(--p) = static_cast<uint8_t>(s & 0xff);
    s >>= 8;
  }
}

inline void enc_put(RansState& s, uint8_t*& p, uint32_t start, uint32_t freq) {
  enc_renorm(s, p, freq);
  s = ((s / freq) << kScaleBits) + (s % freq) + start;
}

inline void enc_put_bits(RansState& s, uint8_t*& p, uint32_t val) {
  constexpr uint32_t freq = 1u << (kScaleBits - kBypassBits);
  constexpr uint32_t x_max = freq << kEncRenormShift;
  while (s >= x_max) {
    *(--p) = static_cast<uint8_t>(s & 0xff);
    s >>= 8;
  }
  s = (s << kBypassBits) | val;
}

inline void enc_flush_state(const RansState& s, uint8_t*& p) {
  p -= 4;
  p[0] = static_cast<uint8_t>(s >> 0);
  p[1] = static_cast<uint8_t>(s >> 8);
  p[2] = static_cast<uint8_t>(s >> 16);
  p[3] = static_cast<uint8_t>(s >> 24);
}

// Decoder reads stop at the stream's end.  A read past it reads nothing:
// it flags the stream (`past_end`) and lifts the state to the lower bound,
// so no renormalization loop can spin on it.
inline void dec_refill(RansState& s, const uint8_t*& p, const uint8_t* end,
                       bool& past_end) {
  if (p == end) {
    past_end = true;
    s = kLowBound;
    return;
  }
  s = (s << 8) | *p++;
}

inline void dec_init(RansState& s, const uint8_t*& p, const uint8_t* end,
                     bool& past_end) {
  if (end - p < 4) {
    past_end = true;
    s = kLowBound;
    p = end;
    return;
  }
  s = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
      (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24);
  p += 4;
}

inline void dec_advance(RansState& s, const uint8_t*& p, const uint8_t* end,
                        bool& past_end, uint32_t start, uint32_t freq) {
  s = freq * (s >> kScaleBits) + (s & kDecMask) - start;
  while (s < kLowBound) dec_refill(s, p, end, past_end);
}

inline uint32_t dec_get_bits(RansState& s, const uint8_t*& p,
                             const uint8_t* end, bool& past_end) {
  uint32_t val = s & kMaxBypassVal;
  s >>= kBypassBits;
  if (s < kLowBound) dec_refill(s, p, end, past_end);
  return val;
}

// --------------------------------------------------------------------------
// CDF group: quantized CDF rows + per-row offsets, plus the encoder-side
// (start, range) view and the decoder-side optional fast LUT.
// --------------------------------------------------------------------------

struct Sym {
  uint16_t start;
  uint16_t range;
};

struct CdfGroup {
  std::vector<std::vector<int32_t>> cdfs;   // rows, each size per row
  std::vector<int32_t> sizes;               // valid entries per row
  std::vector<int32_t> offsets;             // symbol offset per row
  std::vector<std::vector<Sym>> syms;       // encoder view
  std::vector<std::vector<uint8_t>> lut;    // decoder LUT (optional)
  bool has_lut = false;
};

CdfGroup build_group(const int32_t* cdfs, int n_cdf, int row_len,
                     const int32_t* sizes, const int32_t* offsets,
                     bool build_lut) {
  CdfGroup g;
  g.cdfs.resize(n_cdf);
  g.sizes.assign(sizes, sizes + n_cdf);
  g.offsets.assign(offsets, offsets + n_cdf);
  g.syms.resize(n_cdf);
  for (int i = 0; i < n_cdf; ++i) {
    const int32_t* row = cdfs + static_cast<int64_t>(i) * row_len;
    const int sz = sizes[i];
    g.cdfs[i].assign(row, row + sz);
    g.syms[i].resize(sz > 0 ? sz - 1 : 0);
    for (int j = 0; j + 1 < sz; ++j) {
      g.syms[i][j] = Sym{static_cast<uint16_t>(row[j]),
                         static_cast<uint16_t>(row[j + 1] - row[j])};
    }
  }
  if (build_lut) {
    g.lut.resize(n_cdf);
    for (int i = 0; i < n_cdf; ++i) {
      const auto& cdf = g.cdfs[i];
      const int n_sym = static_cast<int>(cdf.size()) - 1;
      if (n_sym <= 0 || n_sym > 255) continue;
      auto& lut = g.lut[i];
      lut.resize(1u << kScaleBits);
      int s = 0;
      for (uint32_t f = 0; f < (1u << kScaleBits); ++f) {
        while (s + 1 < n_sym && static_cast<uint32_t>(cdf[s + 1]) <= f) ++s;
        lut[f] = static_cast<uint8_t>(s);
      }
    }
    g.has_lut = true;
  }
  return g;
}

// --------------------------------------------------------------------------
// Encoder core: queues tasks, emits the stream back-to-front on flush.
// --------------------------------------------------------------------------

enum class TaskKind { Y, Z, Flush };

struct Task {
  TaskKind kind;
  std::shared_ptr<std::vector<int16_t>> y;
  std::shared_ptr<std::vector<int8_t>> z;
  std::shared_ptr<std::vector<uint8_t>> idx;  // decode-y indexes
  int total = 0;
  int group = 0;
  int start_offset = 0;
  int per_channel = 0;
  int idx_base = 0;
  int interleaved = 0;
};

inline void encode_one(RansState& rans, uint8_t*& ptr, int32_t symbol,
                       int32_t cdf_size, int32_t offset,
                       const std::vector<Sym>& syms) {
  const int32_t max_value = cdf_size - 2;
  int32_t value = symbol - offset;
  uint32_t raw_val = 0;
  if (value < 0) {
    raw_val = static_cast<uint32_t>(-2 * value - 1);
    value = max_value;
  } else if (value >= max_value) {
    raw_val = static_cast<uint32_t>(2 * (value - max_value));
    value = max_value;
  }
  if (value == max_value) {
    uint16_t bins[24];
    int nb = 0;
    int32_t n_bypass = 0;
    while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
    int32_t val = n_bypass;
    while (val >= static_cast<int32_t>(kMaxBypassVal)) {
      bins[nb++] = static_cast<uint16_t>(kMaxBypassVal);
      val -= kMaxBypassVal;
    }
    bins[nb++] = static_cast<uint16_t>(val);
    for (int32_t j = 0; j < n_bypass; ++j) {
      bins[nb++] =
          static_cast<uint16_t>((raw_val >> (j * kBypassBits)) & kMaxBypassVal);
    }
    for (int j = nb - 1; j >= 0; --j) enc_put_bits(rans, ptr, bins[j]);
  }
  enc_put(rans, ptr, syms[value].start, syms[value].range);
}

class EncoderCore {
 public:
  int add_cdf(CdfGroup&& g) {
    groups_.push_back(std::move(g));
    return static_cast<int>(groups_.size()) - 1;
  }
  void clear_cdfs() { groups_.clear(); }

  void queue(Task&& t) { pending_.push_back(std::move(t)); }

  void reset() {
    pending_.clear();
    stream_.clear();
  }

  void do_flush() {
    int64_t total = 0;
    for (const auto& t : pending_) {
      if (t.kind == TaskKind::Y) total += static_cast<int64_t>(t.y->size());
      else if (t.kind == TaskKind::Z) total += static_cast<int64_t>(t.z->size());
    }
    if (total == 0) {
      stream_.clear();
      return;
    }
    // 4 bytes/symbol is a hard upper bound (<=30 bits even in full-escape
    // mode) plus the 4-byte state flush.
    std::vector<uint8_t> buf(static_cast<size_t>(total) * 4 + 8);
    uint8_t* end = buf.data() + buf.size();
    uint8_t* ptr = end;

    RansState rans;
    enc_init(rans);
    for (auto it = pending_.rbegin(); it != pending_.rend(); ++it) {
      const Task& t = *it;
      const CdfGroup& g = groups_[t.group];
      if (t.kind == TaskKind::Y) {
        const int16_t* sp = t.y->data();
        for (int i = static_cast<int>(t.y->size()) - 1; i >= 0; --i) {
          const int32_t combined = sp[i];
          const int32_t cdf_idx = combined & 0xff;
          const int32_t s = combined >> 8;
          encode_one(rans, ptr, s, g.sizes[cdf_idx], g.offsets[cdf_idx],
                     g.syms[cdf_idx]);
        }
      } else if (t.kind == TaskKind::Z) {
        const int8_t* sp = t.z->data();
        for (int i = static_cast<int>(t.z->size()) - 1; i >= 0; --i) {
          const int32_t cdf_idx =
              t.interleaved
                  ? ((t.idx_base + i) % t.per_channel + t.start_offset)
                  : ((t.idx_base + i) / t.per_channel + t.start_offset);
          encode_one(rans, ptr, sp[i], g.sizes[cdf_idx], g.offsets[cdf_idx],
                     g.syms[cdf_idx]);
        }
      }
    }
    enc_flush_state(rans, ptr);
    stream_.assign(ptr, end);
    pending_.clear();
  }

  std::vector<uint8_t> stream_;

 private:
  std::vector<CdfGroup> groups_;
  std::list<Task> pending_;
};

// Threaded wrapper: encode_* queue instantly; flush hands the queue to a
// worker so host rANS overlaps device compute (reference design:
// rans.cpp:256-330).
class ThreadedEncoder {
 public:
  explicit ThreadedEncoder(bool threaded) : threaded_(threaded) {
    if (threaded_) worker_ = std::thread(&ThreadedEncoder::run, this);
  }
  ~ThreadedEncoder() {
    if (threaded_) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        finish_ = true;
      }
      cv_.notify_all();
      cv_done_.notify_all();
      worker_.join();
    }
  }

  int add_cdf(CdfGroup&& g) {
    std::lock_guard<std::mutex> lk(mu_);
    return core_.add_cdf(std::move(g));
  }
  void clear_cdfs() {
    std::lock_guard<std::mutex> lk(mu_);
    core_.clear_cdfs();
  }
  void reset() {
    std::lock_guard<std::mutex> lk(mu_);
    core_.reset();
    ready_ = false;
  }
  void queue(Task&& t) {
    std::lock_guard<std::mutex> lk(mu_);
    core_.queue(std::move(t));
  }
  void flush() {
    if (!threaded_) {
      core_.do_flush();
      ready_ = true;
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      flush_requested_ = true;
    }
    cv_.notify_one();
  }
  const std::vector<uint8_t>& get_stream() {
    if (!threaded_) return core_.stream_;
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return ready_ || finish_; });
    return core_.stream_;
  }

 private:
  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] { return flush_requested_ || finish_; });
      if (finish_) return;
      flush_requested_ = false;
      core_.do_flush();
      ready_ = true;
      lk.unlock();
      cv_done_.notify_all();
    }
  }

  EncoderCore core_;
  bool threaded_;
  bool finish_ = false;
  bool ready_ = false;
  bool flush_requested_ = false;
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_, cv_done_;
};

// --------------------------------------------------------------------------
// Decoder core
// --------------------------------------------------------------------------

class DecoderCore {
 public:
  int add_cdf(CdfGroup&& g) {
    groups_.push_back(std::move(g));
    return static_cast<int>(groups_.size()) - 1;
  }
  void clear_cdfs() { groups_.clear(); }

  void set_stream(std::vector<uint8_t>&& s) {
    stream_ = std::move(s);
    ptr_ = stream_.data();
    end_ = ptr_ + stream_.size();
    broken_ = false;
    dec_init(rans_, ptr_, end_, broken_);
  }

  // What check_end needs once every symbol is decoded: a whole stream
  // leaves the state where the encoder began it, and no read passed the
  // end.
  bool broken() const { return broken_; }
  bool state_at_start() const { return rans_ == kLowBound; }
  int64_t consumed() const { return ptr_ - stream_.data(); }

  inline int8_t decode_one(const CdfGroup& g, int cdf_idx) {
    const auto& cdf = g.cdfs[cdf_idx];
    const int32_t cdf_size = g.sizes[cdf_idx];
    const int32_t max_value = cdf_size - 2;
    const uint32_t f = rans_ & kDecMask;
    int32_t s;
    if (g.has_lut && !g.lut[cdf_idx].empty()) {
      s = g.lut[cdf_idx][f];
    } else {
      s = 1;
      while (static_cast<uint32_t>(cdf[s]) <= f) ++s;
      s -= 1;  // largest s with cdf[s] <= f
    }
    dec_advance(rans_, ptr_, end_, broken_, cdf[s], cdf[s + 1] - cdf[s]);
    int32_t value = s;
    if (value == max_value) {
      int32_t val =
          static_cast<int32_t>(dec_get_bits(rans_, ptr_, end_, broken_));
      int32_t n_bypass = val;
      while (val == static_cast<int32_t>(kMaxBypassVal)) {
        val = static_cast<int32_t>(dec_get_bits(rans_, ptr_, end_, broken_));
        n_bypass += val;
      }
      if (n_bypass > kMaxBypassCount) {
        broken_ = true;
        n_bypass = kMaxBypassCount;
      }
      uint32_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        raw_val |= dec_get_bits(rans_, ptr_, end_, broken_)
                   << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    return static_cast<int8_t>(value + g.offsets[cdf_idx]);
  }

  void decode_y(const std::vector<uint8_t>& idx, int group) {
    const CdfGroup& g = groups_[group];
    decoded_.resize(idx.size());
    for (size_t i = 0; i < idx.size(); ++i) {
      decoded_[i] = decode_one(g, idx[i]);
    }
  }

  void decode_z(int total, int group, int start_offset, int per_channel,
                int idx_base, int interleaved) {
    const CdfGroup& g = groups_[group];
    decoded_.resize(total);
    for (int i = 0; i < total; ++i) {
      const int cdf_idx = interleaved
                              ? ((idx_base + i) % per_channel + start_offset)
                              : ((idx_base + i) / per_channel + start_offset);
      decoded_[i] = decode_one(g, cdf_idx);
    }
  }

  std::vector<int8_t> decoded_;

 private:
  std::vector<CdfGroup> groups_;
  std::vector<uint8_t> stream_;
  const uint8_t* ptr_ = nullptr;
  const uint8_t* end_ = nullptr;
  bool broken_ = false;
  RansState rans_ = 0;
};

class ThreadedDecoder {
 public:
  explicit ThreadedDecoder(bool threaded) : threaded_(threaded) {
    if (threaded_) worker_ = std::thread(&ThreadedDecoder::run, this);
  }
  ~ThreadedDecoder() {
    if (threaded_) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        finish_ = true;
      }
      cv_.notify_all();
      cv_done_.notify_all();
      worker_.join();
    }
  }

  int add_cdf(CdfGroup&& g) {
    std::lock_guard<std::mutex> lk(mu_);
    return core_.add_cdf(std::move(g));
  }
  void clear_cdfs() {
    std::lock_guard<std::mutex> lk(mu_);
    core_.clear_cdfs();
  }
  void set_stream(std::vector<uint8_t>&& s) {
    std::lock_guard<std::mutex> lk(mu_);
    core_.set_stream(std::move(s));
  }
  void submit(Task&& t) {
    if (!threaded_) {
      exec(t);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      ready_ = false;
      pending_.push_back(std::move(t));
    }
    cv_.notify_one();
  }
  const std::vector<int8_t>& get_decoded() {
    if (!threaded_) return core_.decoded_;
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return (ready_ && pending_.empty()) || finish_; });
    return core_.decoded_;
  }
  // Waits for the queued decodes, as get_decoded does; the core is idle
  // after.
  const DecoderCore& idle_core() {
    get_decoded();
    return core_;
  }

 private:
  void exec(const Task& t) {
    if (t.kind == TaskKind::Y) {
      core_.decode_y(*t.idx, t.group);
    } else {
      core_.decode_z(t.total, t.group, t.start_offset, t.per_channel,
                     t.idx_base, t.interleaved);
    }
  }
  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu_);
      cv_.wait(lk, [this] { return !pending_.empty() || finish_; });
      if (finish_) return;
      while (!pending_.empty()) {
        Task t = std::move(pending_.front());
        pending_.pop_front();
        lk.unlock();
        exec(t);
        lk.lock();
      }
      ready_ = true;
      lk.unlock();
      cv_done_.notify_all();
    }
  }

  DecoderCore core_;
  bool threaded_;
  bool finish_ = false;
  // true until a task is queued, so a wait with nothing queued returns
  bool ready_ = true;
  std::thread worker_;
  std::mutex mu_;
  std::condition_variable cv_, cv_done_;
  std::list<Task> pending_;
};

// --------------------------------------------------------------------------
// Pair-level objects: optional dual-coder symbol split + stream packing
// (head-to-head with trailing-identical-byte trim).
// --------------------------------------------------------------------------

struct EncoderPair {
  explicit EncoderPair(bool threaded)
      : e0(threaded), e1(threaded) {}
  ThreadedEncoder e0, e1;
  bool use_two = false;
  std::vector<uint8_t> packed;
};

struct DecoderPair {
  explicit DecoderPair(bool threaded)
      : d0(threaded), d1(threaded) {}
  ThreadedDecoder d0, d1;
  bool use_two = false;
  int64_t n_stream = 0;
  std::vector<int8_t> merged;
};

}  // namespace

// --------------------------------------------------------------------------
// C API
// --------------------------------------------------------------------------

extern "C" {

void* rve_enc_new(int threaded) { return new EncoderPair(threaded != 0); }
void rve_enc_free(void* h) { delete static_cast<EncoderPair*>(h); }

int rve_enc_add_cdf(void* h, const int32_t* cdfs, int n_cdf, int row_len,
                    const int32_t* sizes, const int32_t* offsets,
                    int build_lut) {
  auto* e = static_cast<EncoderPair*>(h);
  int idx = e->e0.add_cdf(build_group(cdfs, n_cdf, row_len, sizes, offsets,
                                      false));
  e->e1.add_cdf(build_group(cdfs, n_cdf, row_len, sizes, offsets, false));
  (void)build_lut;  // LUT is a decoder-side optimization
  return idx;
}

void rve_enc_clear_cdfs(void* h) {
  auto* e = static_cast<EncoderPair*>(h);
  e->e0.clear_cdfs();
  e->e1.clear_cdfs();
}

void rve_enc_set_two(void* h, int two) {
  static_cast<EncoderPair*>(h)->use_two = (two != 0);
}

void rve_enc_reset(void* h) {
  auto* e = static_cast<EncoderPair*>(h);
  e->e0.reset();
  e->e1.reset();
}

void rve_enc_y(void* h, const int16_t* symbols, int n, int group) {
  auto* e = static_cast<EncoderPair*>(h);
  if (e->use_two) {
    const int n0 = n / 2;
    Task t0;
    t0.kind = TaskKind::Y;
    t0.y = std::make_shared<std::vector<int16_t>>(symbols, symbols + n0);
    t0.group = group;
    e->e0.queue(std::move(t0));
    Task t1;
    t1.kind = TaskKind::Y;
    t1.y = std::make_shared<std::vector<int16_t>>(symbols + n0, symbols + n);
    t1.group = group;
    e->e1.queue(std::move(t1));
  } else {
    Task t;
    t.kind = TaskKind::Y;
    t.y = std::make_shared<std::vector<int16_t>>(symbols, symbols + n);
    t.group = group;
    e->e0.queue(std::move(t));
  }
}

void rve_enc_z(void* h, const int8_t* symbols, int n, int group,
               int start_offset, int per_channel, int interleaved,
               int idx_base) {
  auto* e = static_cast<EncoderPair*>(h);
  auto make = [&](const int8_t* b, const int8_t* ed, int base) {
    Task t;
    t.kind = TaskKind::Z;
    t.z = std::make_shared<std::vector<int8_t>>(b, ed);
    t.group = group;
    t.start_offset = start_offset;
    t.per_channel = per_channel;
    t.idx_base = base;
    t.interleaved = interleaved;
    return t;
  };
  if (e->use_two) {
    const int n0 = n / 2;
    e->e0.queue(make(symbols, symbols + n0, idx_base));
    e->e1.queue(make(symbols + n0, symbols + n, idx_base + n0));
  } else {
    e->e0.queue(make(symbols, symbols + n, idx_base));
  }
}

void rve_enc_flush(void* h) {
  auto* e = static_cast<EncoderPair*>(h);
  e->e0.flush();
  e->e1.flush();
}

// Blocks until the stream is ready; returns its size and caches the packed
// bytes for rve_enc_get_stream.
int rve_enc_stream_size(void* h) {
  auto* e = static_cast<EncoderPair*>(h);
  const auto& s0 = e->e0.get_stream();
  if (!e->use_two) {
    e->packed = s0;
    return static_cast<int>(e->packed.size());
  }
  const auto& s1 = e->e1.get_stream();
  const int n0 = static_cast<int>(s0.size());
  const int n1 = static_cast<int>(s1.size());
  // Trim bytes that are identical (zero) at both tails so the two streams
  // can share them when packed head-to-head (reference trick,
  // py_rans.cpp:117-131).
  int identical = 0;
  int check = std::min(std::min(n0, n1), kMaxSharedTail);
  for (int i = 0; i < check; ++i) {
    if (s0[n0 - 1 - i] != 0 || s1[n1 - 1 - i] != 0) break;
    ++identical;
  }
  if (identical == 0 && n0 > 0 && n1 > 0 && s0[n0 - 1] == s1[n1 - 1]) {
    identical = 1;
  }
  e->packed.resize(n0 + n1 - identical);
  std::copy(s0.begin(), s0.end(), e->packed.begin());
  std::reverse_copy(s1.begin(), s1.end() - identical,
                    e->packed.begin() + n0);
  return static_cast<int>(e->packed.size());
}

void rve_enc_get_stream(void* h, uint8_t* out) {
  auto* e = static_cast<EncoderPair*>(h);
  std::memcpy(out, e->packed.data(), e->packed.size());
}

void* rve_dec_new(int threaded) { return new DecoderPair(threaded != 0); }
void rve_dec_free(void* h) { delete static_cast<DecoderPair*>(h); }

int rve_dec_add_cdf(void* h, const int32_t* cdfs, int n_cdf, int row_len,
                    const int32_t* sizes, const int32_t* offsets,
                    int build_lut) {
  auto* d = static_cast<DecoderPair*>(h);
  int idx = d->d0.add_cdf(build_group(cdfs, n_cdf, row_len, sizes, offsets,
                                      build_lut != 0));
  d->d1.add_cdf(build_group(cdfs, n_cdf, row_len, sizes, offsets,
                            build_lut != 0));
  return idx;
}

void rve_dec_clear_cdfs(void* h) {
  auto* d = static_cast<DecoderPair*>(h);
  d->d0.clear_cdfs();
  d->d1.clear_cdfs();
}

void rve_dec_set_two(void* h, int two) {
  static_cast<DecoderPair*>(h)->use_two = (two != 0);
}

// Each decoder reads within the n bytes: the first from the head, the
// second (two coders) from the tail; each needs its 4-byte state there.
void rve_dec_set_stream(void* h, const uint8_t* data, int n) {
  auto* d = static_cast<DecoderPair*>(h);
  d->n_stream = n;
  d->d0.set_stream(std::vector<uint8_t>(data, data + n));
  if (d->use_two) {
    std::vector<uint8_t> rev(n);
    std::reverse_copy(data, data + n, rev.begin());
    d->d1.set_stream(std::move(rev));
  }
}

void rve_dec_y(void* h, const uint8_t* indexes, int n, int group) {
  auto* d = static_cast<DecoderPair*>(h);
  if (d->use_two) {
    const int n0 = n / 2;
    Task t0;
    t0.kind = TaskKind::Y;
    t0.idx = std::make_shared<std::vector<uint8_t>>(indexes, indexes + n0);
    t0.group = group;
    d->d0.submit(std::move(t0));
    Task t1;
    t1.kind = TaskKind::Y;
    t1.idx = std::make_shared<std::vector<uint8_t>>(indexes + n0, indexes + n);
    t1.group = group;
    d->d1.submit(std::move(t1));
  } else {
    Task t;
    t.kind = TaskKind::Y;
    t.idx = std::make_shared<std::vector<uint8_t>>(indexes, indexes + n);
    t.group = group;
    d->d0.submit(std::move(t));
  }
}

void rve_dec_z(void* h, int total, int group, int start_offset,
               int per_channel, int interleaved, int idx_base) {
  auto* d = static_cast<DecoderPair*>(h);
  auto make = [&](int count, int base) {
    Task t;
    t.kind = TaskKind::Z;
    t.total = count;
    t.group = group;
    t.start_offset = start_offset;
    t.per_channel = per_channel;
    t.idx_base = base;
    t.interleaved = interleaved;
    return t;
  };
  if (d->use_two) {
    const int n0 = total / 2;
    d->d0.submit(make(n0, idx_base));
    d->d1.submit(make(total - n0, idx_base + n0));
  } else {
    d->d0.submit(make(total, idx_base));
  }
}

// Blocks until decode finishes; returns size and caches merged output,
// or -1 when a decoder read past the stream's end or met an impossible
// escape.
int rve_dec_size(void* h) {
  auto* d = static_cast<DecoderPair*>(h);
  const auto& r0 = d->d0.get_decoded();
  if (d->d0.idle_core().broken() ||
      (d->use_two && d->d1.idle_core().broken())) {
    return -1;
  }
  if (!d->use_two) {
    d->merged = r0;
    return static_cast<int>(d->merged.size());
  }
  const auto& r1 = d->d1.get_decoded();
  d->merged.resize(r0.size() + r1.size());
  std::copy(r0.begin(), r0.end(), d->merged.begin());
  std::copy(r1.begin(), r1.end(), d->merged.begin() + r0.size());
  return static_cast<int>(d->merged.size());
}

void rve_dec_get(void* h, int8_t* out) {
  auto* d = static_cast<DecoderPair*>(h);
  std::memcpy(out, d->merged.data(), d->merged.size());
}

// After a stream's last symbol (blocks until it is decoded): 0 when the
// stream decoded whole, -1 when a read passed its end or met an impossible
// escape, -2 when the decoders did not read every byte exactly once (two
// coders may share at most the encoder's trimmed tail), -3 when a
// decoder's final state is not the state its encoder started from.
int rve_dec_check_end(void* h) {
  auto* d = static_cast<DecoderPair*>(h);
  const DecoderCore& c0 = d->d0.idle_core();
  if (!d->use_two) {
    if (c0.broken()) return -1;
    if (c0.consumed() != d->n_stream) return -2;
    return c0.state_at_start() ? 0 : -3;
  }
  const DecoderCore& c1 = d->d1.idle_core();
  if (c0.broken() || c1.broken()) return -1;
  const int64_t both = c0.consumed() + c1.consumed();
  if (both < d->n_stream || both > d->n_stream + kMaxSharedTail) return -2;
  return (c0.state_at_start() && c1.state_at_start()) ? 0 : -3;
}

}  // extern "C"
