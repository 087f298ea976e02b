// W1: the bilinear backward warp of ops/warp.py::flow_warp for Hopper
// (sm_90a), with an optional mask product in the same pass.
//
//   out[u, c, y, x] = warp(im[u, c], flow[u])(y, x)     [* mask[u, 0, y, x]]
//
// The sample of pixel (x, y) is at (x + dx, y + dy), clamped to the border;
// its four taps are weighted by the fractional position.  This replaces no
// TPU kernel: the JAX package leaves the warp to XLA.  The published
// DCVC-FM ships the same operation as a CUDA kernel (`block_mc`).  In
// eager PyTorch the plain warp ran about 40 ATen kernels a call: four
// gathers over an int64 index expanded across the channels, broadcast
// products and sums, a cast, and the offset diversity's mask product
// after it.  Here a thread reads its pixel's (dx, dy) once, computes the
// sample position and the four weights once, and then, for each of its
// channels, loads the four taps, sums them, rounds, multiplies by the
// mask and stores.  So the kernel moves each flow, mask and output value
// once and the source's taps through L1 / L2; it is bound by those bytes
// at 3.35 TB/s.  Neighbouring threads take neighbouring x, so flow, mask
// and output accesses are coalesced.  A unit with many channels is split
// into groups of at most kChannelsPerThread channels.  The grid is
// (pixel blocks, channel groups, units), so the blocks run channel group
// by channel group, and the index arithmetic is 32-bit but for the
// plane offsets.  The channel loop is unrolled to keep several taps in
// flight.  On an H100 (float32, flows of +-8 px) this layout ran FM's
// 48-, 64- and 96-channel calls 10-13 % faster than a 1-D grid that put
// a pixel block's groups side by side, and the offset diversity (32
// units of 3 channels) within 1 %; bfloat16 moved within 2 %.  One
// thread over all of a unit's channels (F.grid_sample's layout) ran the
// 48- and 64-channel calls 16-20 % slower than this layout.
//
// Bit for bit the plain warp, in float32 and bfloat16: the position
// clamp(x + dx, 0, w - 1) in float32, floor, wx = sx - x0 and 1 - wx,
// x1 = min(x0 + 1, w - 1); each tap as (g * (1 - wx)) * (1 - wy) (and so
// on), the taps summed as ((t00 + t01) + t10) + t11, rounded once to im's
// dtype, then the mask product rounded in that dtype as ATen's mul rounds
// it.  Every product and sum is an explicit __fmul_rn / __fadd_rn, which
// the compiler never contracts into an FMA.  A NaN flow is outside the
// contract (the plain warp's gather index is then undefined).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannelsPerThread = 8;
constexpr int64_t kMaxGridYZ = 65535;    // gridDim.y and .z

struct F32 {
  using Bits = float;
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

struct BF16 {
  using Bits = uint16_t;
  __device__ static float load(uint16_t v) {
    return __uint_as_float(uint32_t(v) << 16);
  }
  __device__ static uint16_t store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static float round(float v) { return load(store(v)); }
};

// E: im's (and mask's and out's) element type; FE: flow's.  Grid: (pixel
// blocks, channel groups of cpt channels, units).
template <typename E, typename FE, bool MASK>
__global__ void __launch_bounds__(kThreads)
flow_warp_kernel(const typename E::Bits* __restrict__ im,
                 const typename FE::Bits* __restrict__ flow,
                 const typename E::Bits* __restrict__ mask,
                 typename E::Bits* __restrict__ out, int H, int W, int C,
                 int cpt) {
  int64_t unit = blockIdx.z;
  int hw = H * W;
  int p = blockIdx.x * kThreads + threadIdx.x;
  bool ok = p < hw;
  int q = ok ? p : 0;    // a thread past the plane reads pixel 0, stores none
  int y = q / W;
  int x = q - y * W;

  const typename FE::Bits* fl = flow + unit * 2 * hw;
  float sx = fminf(fmaxf(__fadd_rn((float)x, FE::load(fl[q])), 0.0f),
                   (float)(W - 1));
  float sy = fminf(fmaxf(__fadd_rn((float)y, FE::load(fl[hw + q])), 0.0f),
                   (float)(H - 1));
  float fx0 = floorf(sx), fy0 = floorf(sy);
  float wx = __fsub_rn(sx, fx0), wy = __fsub_rn(sy, fy0);
  float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  int x0 = (int)fx0, y0 = (int)fy0;
  int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  int i00 = y0 * W + x0, i01 = y0 * W + x1;
  int i10 = y1 * W + x0, i11 = y1 * W + x1;
  float m = MASK ? E::load(mask[unit * hw + q]) : 0.0f;

  int c0 = blockIdx.y * cpt;
  int c1 = min(c0 + cpt, C);
  int64_t base = (unit * C + c0) * (int64_t)hw;
  const typename E::Bits* src = im + base;
  typename E::Bits* dst = out + base;
#pragma unroll 4
  for (int c = c0; c < c1; ++c, src += hw, dst += hw) {
    float t00 = __fmul_rn(__fmul_rn(E::load(src[i00]), ux), uy);
    float t01 = __fmul_rn(__fmul_rn(E::load(src[i01]), wx), uy);
    float t10 = __fmul_rn(__fmul_rn(E::load(src[i10]), ux), wy);
    float t11 = __fmul_rn(__fmul_rn(E::load(src[i11]), wx), wy);
    float v = E::round(__fadd_rn(__fadd_rn(__fadd_rn(t00, t01), t10), t11));
    if (MASK) v = __fmul_rn(v, m);
    if (ok) dst[p] = E::store(v);
  }
}

template <typename E, typename FE>
int launch(const void* im, const void* flow, const void* mask, void* out,
           int64_t units, int64_t C, int64_t H, int64_t W,
           cudaStream_t stream) {
  using T = typename E::Bits;
  using FT = typename FE::Bits;
  int64_t hw = H * W;
  int64_t groups = (C + kChannelsPerThread - 1) / kChannelsPerThread;
  if (groups > kMaxGridYZ) return (int)cudaErrorInvalidValue;
  int cpt = (int)((C + groups - 1) / groups);
  dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)groups);
  // at most kMaxGridYZ units a launch
  for (int64_t u0 = 0; u0 < units; u0 += kMaxGridYZ) {
    grid.z = (unsigned)(units - u0 < kMaxGridYZ ? units - u0 : kMaxGridYZ);
    const T* ip = (const T*)im + u0 * C * hw;
    const FT* fp = (const FT*)flow + u0 * 2 * hw;
    const T* mp = mask ? (const T*)mask + u0 * hw : nullptr;
    T* op = (T*)out + u0 * C * hw;
    if (mp)
      flow_warp_kernel<E, FE, true><<<grid, kThreads, 0, stream>>>(
          ip, fp, mp, op, (int)H, (int)W, (int)C, cpt);
    else
      flow_warp_kernel<E, FE, false><<<grid, kThreads, 0, stream>>>(
          ip, fp, mp, op, (int)H, (int)W, (int)C, cpt);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

}  // namespace

// im (units, C, H, W) and out of `dtype`, flow (units, 2, H, W) of
// `flow_dtype`, mask (units, 1, H, W) of `dtype` or null; all contiguous,
// out not aliasing an input.  dtype codes: 0 float32, 1 bfloat16.  Returns
// the cudaError_t of its launches (0 on success).
extern "C" int flow_warp_launch(const void* im, const void* flow,
                                const void* mask, void* out, int64_t units,
                                int64_t C, int64_t H, int64_t W, int dtype,
                                int flow_dtype, void* stream) {
  if (units < 0 || C < 1 || H < 1 || W < 1 || H * W > INT32_MAX - kThreads)
    return (int)cudaErrorInvalidValue;
  if (units == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && flow_dtype == 0)
    return launch<F32, F32>(im, flow, mask, out, units, C, H, W, s);
  if (dtype == 0 && flow_dtype == 1)
    return launch<F32, BF16>(im, flow, mask, out, units, C, H, W, s);
  if (dtype == 1 && flow_dtype == 0)
    return launch<BF16, F32>(im, flow, mask, out, units, C, H, W, s);
  if (dtype == 1 && flow_dtype == 1)
    return launch<BF16, BF16>(im, flow, mask, out, units, C, H, W, s);
  return (int)cudaErrorInvalidValue;
}
