// The DepthConvBlock's elementwise epilogues for Hopper (sm_90a): what
// layers/blocks.py::depth_conv_block_apply does between its convolutions.
//
//   dcb_elementwise_bias                 y = c + b[ch]
//   dcb_elementwise_bias_wsilu           t = c + b[ch]; t * sigmoid(4 t)
//   dcb_elementwise_bias_wsilu_chunk_add the sum of the two channel halves
//                                        of the above, (N, 2K) -> (N, K)
//   dcb_elementwise_bias_residual        ((c + b[ch]) + r [+ x]) [* q[ch]]
//
// The bias and residual kernels write y into `out`, which is c itself on
// the inference path (in place) and a new tensor under autograd, whose
// backward reads c again; so c and out carry no __restrict__.
//
// They replace no TPU kernel: the JAX package leaves these chains to XLA,
// which fuses them.  In eager PyTorch the same block ran 14 ATen
// elementwise kernels (a bias add after each of five convolutions, WSiLU
// as three kernels twice, the chunk add, two residual adds), each a round
// trip of a whole plane through device memory.  Counting a C-channel plane
// read or written as one unit: the chain moves about 63 units a block,
// these kernels 16 (dc1 2, the depthwise conv 2, dc2 3, ffn1 6, ffn2 3,
// plus 1 for the shortcut), so they are bound by those bytes at 3.35 TB/s;
// the arithmetic is a few operations an element.  A thread moves one
// 16-byte vector of each operand (4 float32 or 8 bfloat16 elements) where
// HW and every pointer allow it, else 8, 4 or 2 bytes; a vector then never
// straddles a channel, so its bias (and quant step) is one load.
//
// Bit for bit the unfused chain, which stores every op's result in the
// tensor's dtype: each step is rounded to the storage type as ATen rounds
// it (round to nearest even), the arithmetic is float (ATen's opmath), and
// every product and sum is an explicit __fmul_rn / __fadd_rn, which the
// compiler never contracts into an FMA.  The sigmoid is ATen's own
// expression, 1 / (1 + exp(-u)), with the accurate expf (no fast math).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
// elements of one launch stay below 2^31, so 32-bit indices never wrap;
// a larger batch is launched in slices of whole samples
constexpr int64_t kMaxLaunchElems = (int64_t(1) << 31) - 1;

struct F32 {
  using Bits = float;
  static constexpr int kBytes = 4;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

struct BF16 {
  using Bits = uint16_t;
  static constexpr int kBytes = 2;
  __device__ static float load(uint16_t v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  __device__ static uint16_t store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static float round(float v) { return load(store(v)); }
};

template <int B> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// V elements of E moved as one load or store
template <typename E, int V> union Pack {
  using RawT = typename Raw<E::kBytes * V>::type;
  RawT raw;
  typename E::Bits v[V];
};

template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load_pack(const typename E::Bits* p,
                                                uint32_t iv) {
  Pack<E, V> out;
  out.raw = reinterpret_cast<const typename Pack<E, V>::RawT*>(p)[iv];
  return out;
}

template <typename E, int V>
__device__ __forceinline__ void store_pack(typename E::Bits* p, uint32_t iv,
                                           const Pack<E, V>& v) {
  reinterpret_cast<typename Pack<E, V>::RawT*>(p)[iv] = v.raw;
}

// ATen's sigmoid (UnarySpecialOpsKernel.cu): one / (one + exp(-a)) in
// float opmath
__device__ __forceinline__ float aten_sigmoid(float u) {
  return 1.0f / (1.0f + expf(-u));
}

// WSiLU of t (already rounded to E): 4 t, its sigmoid and the product,
// each rounded as the chain stores it
template <typename E>
__device__ __forceinline__ float wsilu(float t) {
  float u = E::round(__fmul_rn(t, 4.0f));
  float s = E::round(aten_sigmoid(u));
  return E::round(__fmul_rn(t, s));
}

template <typename E>
__device__ __forceinline__ float bias_add(typename E::Bits c, float b) {
  return E::round(__fadd_rn(E::load(c), b));
}

template <typename E, int V, bool WSILU>
__global__ void __launch_bounds__(kThreads)
dcb_elementwise_bias(const typename E::Bits* c,
                     const typename E::Bits* __restrict__ b,
                     typename E::Bits* out, uint32_t n_vec, uint32_t hw_vec,
                     uint32_t C) {
  uint32_t iv = blockIdx.x * kThreads + threadIdx.x;
  if (iv >= n_vec) return;
  float bias = E::load(b[(iv / hw_vec) % C]);
  Pack<E, V> p = load_pack<E, V>(c, iv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float t = bias_add<E>(p.v[k], bias);
    if (WSILU) t = wsilu<E>(t);
    p.v[k] = E::store(t);
  }
  store_pack<E, V>(out, iv, p);
}

// c (N, 2K, HW) -> out (N, K, HW); iv counts output vectors
template <typename E, int V>
__global__ void __launch_bounds__(kThreads)
dcb_elementwise_bias_wsilu_chunk_add(const typename E::Bits* __restrict__ c,
                                     const typename E::Bits* __restrict__ b,
                                     typename E::Bits* __restrict__ out,
                                     uint32_t n_vec, uint32_t hw_vec,
                                     uint32_t K) {
  uint32_t iv = blockIdx.x * kThreads + threadIdx.x;
  if (iv >= n_vec) return;
  uint32_t plane = iv / hw_vec;               // n K + k
  uint32_t k = plane % K;
  uint32_t ia = iv + (plane / K) * K * hw_vec;  // (n 2K + k) hw_vec + ...
  uint32_t ib = ia + K * hw_vec;
  float ba = E::load(b[k]), bb = E::load(b[K + k]);
  Pack<E, V> pa = load_pack<E, V>(c, ia), pb = load_pack<E, V>(c, ib), po;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float ya = wsilu<E>(bias_add<E>(pa.v[j], ba));
    float yb = wsilu<E>(bias_add<E>(pb.v[j], bb));
    po.v[j] = E::store(__fadd_rn(ya, yb));
  }
  store_pack<E, V>(out, iv, po);
}

// q: the quant step of (sample n, channel ch) at q[n q_stride + ch]
template <typename E, int V, bool SHORTCUT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
dcb_elementwise_bias_residual(const typename E::Bits* c,
                              const typename E::Bits* __restrict__ b,
                              const typename E::Bits* __restrict__ r,
                              const typename E::Bits* __restrict__ x,
                              const typename E::Bits* __restrict__ q,
                              typename E::Bits* out, uint32_t n_vec, uint32_t hw_vec, uint32_t C,
                              uint32_t q_stride) {
  uint32_t iv = blockIdx.x * kThreads + threadIdx.x;
  if (iv >= n_vec) return;
  uint32_t plane = iv / hw_vec;
  uint32_t ch = plane % C;
  float bias = E::load(b[ch]);
  float qv = QUANT ? E::load(q[(plane / C) * q_stride + ch]) : 0.0f;
  Pack<E, V> pc = load_pack<E, V>(c, iv), pr = load_pack<E, V>(r, iv), px;
  if (SHORTCUT) px = load_pack<E, V>(x, iv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float y = E::round(__fadd_rn(bias_add<E>(pc.v[k], bias),
                                 E::load(pr.v[k])));
    if (SHORTCUT) y = E::round(__fadd_rn(y, E::load(px.v[k])));
    if (QUANT) y = E::round(__fmul_rn(y, qv));
    pc.v[k] = E::store(y);
  }
  store_pack<E, V>(out, iv, pc);
}

// the widest vector (elements) that HW and every pointer allow
template <typename E>
int vec_width(int64_t hw, const void* const* ptrs, int n_ptrs) {
  int v = 16 / E::kBytes;
  for (; v > 1; v /= 2) {
    bool ok = hw % v == 0;
    for (int i = 0; i < n_ptrs && ok; ++i)
      ok = ptrs[i] == nullptr ||
           (uintptr_t)ptrs[i] % (uintptr_t(v) * E::kBytes) == 0;
    if (ok) break;
  }
  return v;
}

// f(std::integral_constant<int, V>) for the runtime width v
template <typename E, typename F>
int with_width(int v, F&& f) {
  switch (v) {
    case 8:
      if constexpr (E::kBytes == 2) return f(std::integral_constant<int, 8>{});
      break;
    case 4: return f(std::integral_constant<int, 4>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 1: return f(std::integral_constant<int, 1>{});
  }
  return (int)cudaErrorInvalidValue;
}

// samples per launch so a launch's elements stay under kMaxLaunchElems;
// 0 when one sample alone is too large
int64_t samples_per_launch(int64_t N, int64_t per_sample) {
  if (per_sample <= 0 || per_sample > kMaxLaunchElems) return 0;
  int64_t s = kMaxLaunchElems / per_sample;
  return s < N ? s : N;
}

uint32_t blocks_for(int64_t n_vec) {
  return (uint32_t)((n_vec + kThreads - 1) / kThreads);
}

template <typename E>
int bias_launch(const void* c, const void* b, void* out, int64_t N,
                int64_t C, int64_t hw, int wsilu, cudaStream_t stream) {
  using T = typename E::Bits;
  const void* ptrs[] = {c, out};
  int v = vec_width<E>(hw, ptrs, 2);
  int64_t per = samples_per_launch(N, C * hw);
  if (per == 0) return (int)cudaErrorInvalidValue;
  for (int64_t n0 = 0; n0 < N; n0 += per) {
    int64_t n = N - n0 < per ? N - n0 : per;
    const T* cp = (const T*)c + n0 * C * hw;
    T* op = (T*)out + n0 * C * hw;
    int err = with_width<E>(v, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      int64_t n_vec = n * C * hw / V;
      if (wsilu)
        dcb_elementwise_bias<E, V, true><<<blocks_for(n_vec), kThreads, 0,
                                           stream>>>(
            cp, (const T*)b, op, (uint32_t)n_vec, (uint32_t)(hw / V),
            (uint32_t)C);
      else
        dcb_elementwise_bias<E, V, false><<<blocks_for(n_vec), kThreads, 0,
                                            stream>>>(
            cp, (const T*)b, op, (uint32_t)n_vec, (uint32_t)(hw / V),
            (uint32_t)C);
      return (int)cudaGetLastError();
    });
    if (err) return err;
  }
  return 0;
}

template <typename E>
int chunk_add_launch(const void* c, const void* b, void* out, int64_t N,
                     int64_t K, int64_t hw, cudaStream_t stream) {
  using T = typename E::Bits;
  const void* ptrs[] = {c, out};
  int v = vec_width<E>(hw, ptrs, 2);
  int64_t per = samples_per_launch(N, 2 * K * hw);
  if (per == 0) return (int)cudaErrorInvalidValue;
  for (int64_t n0 = 0; n0 < N; n0 += per) {
    int64_t n = N - n0 < per ? N - n0 : per;
    const T* cp = (const T*)c + n0 * 2 * K * hw;
    T* op = (T*)out + n0 * K * hw;
    int err = with_width<E>(v, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      int64_t n_vec = n * K * hw / V;
      dcb_elementwise_bias_wsilu_chunk_add<E, V><<<blocks_for(n_vec),
                                                   kThreads, 0, stream>>>(
          cp, (const T*)b, op, (uint32_t)n_vec, (uint32_t)(hw / V),
          (uint32_t)K);
      return (int)cudaGetLastError();
    });
    if (err) return err;
  }
  return 0;
}

template <typename E>
int residual_launch(const void* c, const void* b, const void* r,
                    const void* x, const void* q, void* out, int64_t N,
                    int64_t C, int64_t hw, int64_t q_stride,
                    cudaStream_t stream) {
  using T = typename E::Bits;
  const void* ptrs[] = {c, r, x, out};
  int v = vec_width<E>(hw, ptrs, 4);
  int64_t per = samples_per_launch(N, C * hw);
  if (per == 0 || q_stride < 0 || q_stride > kMaxLaunchElems)
    return (int)cudaErrorInvalidValue;
  for (int64_t n0 = 0; n0 < N; n0 += per) {
    int64_t n = N - n0 < per ? N - n0 : per;
    int64_t off = n0 * C * hw;
    const T* cp = (const T*)c + off;
    T* op = (T*)out + off;
    const T* rp = (const T*)r + off;
    const T* xp = x ? (const T*)x + off : nullptr;
    const T* qp = q ? (const T*)q + n0 * q_stride : nullptr;
    int err = with_width<E>(v, [&](auto vc) {
      constexpr int V = decltype(vc)::value;
      int64_t n_vec = n * C * hw / V;
      uint32_t g = blocks_for(n_vec), nv = (uint32_t)n_vec,
               hv = (uint32_t)(hw / V), cc = (uint32_t)C,
               qs = (uint32_t)q_stride;
      if (xp && qp)
        dcb_elementwise_bias_residual<E, V, true, true>
            <<<g, kThreads, 0, stream>>>(cp, (const T*)b, rp, xp, qp, op, nv,
                                         hv, cc, qs);
      else if (xp)
        dcb_elementwise_bias_residual<E, V, true, false>
            <<<g, kThreads, 0, stream>>>(cp, (const T*)b, rp, xp, qp, op, nv,
                                         hv, cc, qs);
      else if (qp)
        dcb_elementwise_bias_residual<E, V, false, true>
            <<<g, kThreads, 0, stream>>>(cp, (const T*)b, rp, xp, qp, op, nv,
                                         hv, cc, qs);
      else
        dcb_elementwise_bias_residual<E, V, false, false>
            <<<g, kThreads, 0, stream>>>(cp, (const T*)b, rp, xp, qp, op, nv,
                                         hv, cc, qs);
      return (int)cudaGetLastError();
    });
    if (err) return err;
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Every tensor is contiguous NCHW of that
// dtype; b and q have the channel count's elements.  Each returns the
// cudaError_t of its launches (0 on success).

// out (N, C, HW) = c + b, then WSiLU where `wsilu` is nonzero; out may be
// c (in place)
extern "C" int dcb_bias_launch(const void* c, const void* b, void* out,
                               int64_t N, int64_t C, int64_t hw, int wsilu,
                               int dtype, void* stream) {
  if (N < 0 || C < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return bias_launch<F32>(c, b, out, N, C, hw, wsilu, s);
  if (dtype == 1) return bias_launch<BF16>(c, b, out, N, C, hw, wsilu, s);
  return (int)cudaErrorInvalidValue;
}

// out (N, K, HW) = WSiLU(c[:, :K] + b[:K]) + WSiLU(c[:, K:] + b[K:]),
// c (N, 2K, HW)
extern "C" int dcb_chunk_add_launch(const void* c, const void* b, void* out,
                                    int64_t N, int64_t K, int64_t hw,
                                    int dtype, void* stream) {
  if (N < 0 || K < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return chunk_add_launch<F32>(c, b, out, N, K, hw, s);
  if (dtype == 1) return chunk_add_launch<BF16>(c, b, out, N, K, hw, s);
  return (int)cudaErrorInvalidValue;
}

// out (N, C, HW) = ((c + b) + r [+ x]) [* q]; x and q may be null; q's
// sample n starts at q + n q_stride (q_stride 0: one row for all); out
// may be c (in place)
extern "C" int dcb_residual_launch(const void* c, const void* b,
                                   const void* r, const void* x,
                                   const void* q, void* out, int64_t N,
                                   int64_t C, int64_t hw, int64_t q_stride,
                                   int dtype, void* stream) {
  if (N < 0 || C < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return residual_launch<F32>(c, b, r, x, q, out, N, C, hw, q_stride, s);
  if (dtype == 1)
    return residual_launch<BF16>(c, b, r, x, q, out, N, C, hw, q_stride, s);
  return (int)cudaErrorInvalidValue;
}
