// The erf_poly GELU for Hopper (sm_90a), forward and analytic backward:
//
//   fwd: y  = 0.5·x·(1 + erf_poly(x·√½))
//   bwd: dx = (Φ(x) + x·φ(x))·g,  Φ = 0.5·(1 + erf_poly(x·√½)),
//                                 φ = e^(−x²/2)/√(2π)
//
// x, g, y and dx are f32 or bf16 (all one type), contiguous, of any shape
// (taken as flat); every value is computed in f32 and rounded once to that
// type.  erf_poly is the JAX package's exp-free piecewise polynomial
// (meg_decoding_tpu/ops/gelu.py:70-105), with its coefficients, intervals
// and centres as ops/kernels/gelu.py's plain version has them:
//
//   |u| ≤ 1          erf(u) = u·P₆(u²)
//   1 < |u| ≤ 2.2    erf(u) = M₉(|u| − 1.6)       (mirrored by sign)
//   2.2 < |u| ≤ 3.92 erf(u) = T₈(|u| − 3.06)
//   |u| > 3.92       ±1
//
// Each element evaluates the polynomial of its own interval only, the one
// the plain version's where() selects (a NaN falls through to T₈ there and
// here, and stays NaN); Horner takes one fmaf a step where the plain
// version rounds the product and the sum apart, the one difference before
// the final rounding.  The backward's exponential is expf (not __expf).
//
// Replaces no TPU kernel.  In the JAX package the same function is plain
// jnp with a custom JVP (meg_decoding_tpu/ops/gelu.py:95-137), which XLA
// fuses into one elementwise op each way; eager PyTorch runs each of the
// chain's ~70 operations as a kernel of its own that reads and writes the
// whole activation.  These two kernels restore the one pass.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  The forward reads x and writes
// y, the backward reads x and g and writes dx: 4 and 6 bytes an element in
// bf16.  The exact-GELU train step (B = 256, bf16) has 12 GELU sites, 2 in
// each of 5 blocks at (256, 320, 360) and the two final ones at
// (256, 640, 360) and (256, 1024, 360): 448.3 M elements, 1.79 GB forward
// (0.54 ms) and 2.69 GB backward (0.80 ms) a step.  The arithmetic, one
// polynomial of degree 6–9 an element (plus an expf in the backward), is
// some 20 GFLOP a step in f32.
//
// Design against that bound: each thread moves 16-byte packets (4 f32 or 8
// bf16 values) in a grid-stride loop over the packets, so loads and stores
// are coalesced; the values a numel the packet does not divide leaves over
// (or every value, where a pointer is not 16-byte aligned) go one a thread
// in a second grid-stride loop.  No shared memory, nothing but x, g and the
// output in device memory.  The grid is capped at kBlocksPerSm blocks an
// SM, eight times what an SM holds at once, so that a block that finishes
// early is replaced: at the step's shapes a thread takes 1–6 packets.  On
// an NVIDIA H100 80GB HBM3 at 700 W the step's 24 launches took 2.16 ms
// with 8 blocks an SM (one wave, every thread looping), 2.01 with 16, 1.96
// with 32, 1.94 with 64, 1.98 with 128 and 2.00 uncapped (a thread a
// packet); two or four packets loaded before computing were slower (2.19,
// 2.29 ms at 8 blocks an SM; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 64;  // the grid's cap, 8 times an SM's 2,048 threads

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;
constexpr float kUMax = 3.92f;
constexpr float kB1 = 2.2f;
constexpr float kC1 = 1.6f;   // mid-interval Horner centre, (1 + 2.2)/2
constexpr float kC2 = 3.06f;  // tail-interval Horner centre, (2.2 + 3.92)/2

// c[0] + x·(c[1] + x·(… + x·c[N−1])), one fmaf a step
template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float x) {
  float acc = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) acc = fmaf(acc, x, c[i]);
  return acc;
}

__device__ __forceinline__ float erf_poly(float u) {
  // erf(u)/u over u² ∈ [0, 1] (increasing powers of u²)
  constexpr float kP[7] = {
      1.1283791642036094f, -0.3761262253264794f, 0.11283567972615145f,
      -0.026853537766035242f, 0.005188380744448103f, -0.0008014557174955704f,
      7.87898134825695e-05f};
  // erf(u) over u ∈ [1, 2.2] (increasing powers of u − 1.6)
  constexpr float kM[10] = {
      0.9763483813576088f, 0.08722905144327303f, -0.13956618665278978f,
      0.1197950067239394f, -0.049321021018725146f, -0.004384953262741153f,
      0.015549647872260673f, -0.005987836463361508f, -0.0011343875580184023f,
      0.0013519651430629316f};
  // erf(u) over u ∈ [2.2, 3.92] (increasing powers of u − 3.06)
  constexpr float kT[9] = {
      0.9999849227209708f, 9.675459819190899e-05f, -0.00029653724335458495f,
      0.0005731544734380906f, -0.0007728300529582685f, 0.0007715595580880792f,
      -0.00060149821458484f, 0.00034682825182840094f,
      -0.00010350064171581603f};
  const float au = fabsf(u);
  float mag;
  if (au > kUMax) {
    mag = 1.0f;
  } else if (au <= 1.0f) {
    mag = au * horner(kP, au * au);
  } else if (au <= kB1) {
    mag = horner(kM, au - kC1);
  } else {
    mag = horner(kT, au - kC2);
  }
  const float sign = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
  return sign * mag;
}

__device__ __forceinline__ float gelu_fwd(float x) {
  return 0.5f * x * (1.0f + erf_poly(x * kSqrtHalf));
}

__device__ __forceinline__ float gelu_bwd(float x, float g) {
  const float cdf = 0.5f * (1.0f + erf_poly(x * kSqrtHalf));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * x * x);
  return (cdf + x * pdf) * g;
}

// 16-byte packets of E as f32 values and back, and single values
template <typename E>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(uint4 r, float (&f)[kVec]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[kVec]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // a bf16 is the top half of its f32; the value at the lower address is
  // the word's low half
  __device__ static void unpack2(uint32_t w, float& lo, float& hi) {
    lo = __uint_as_float(w << 16);
    hi = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x at the lower address
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void unpack(uint4 r, float (&f)[kVec]) {
    unpack2(r.x, f[0], f[1]);
    unpack2(r.y, f[2], f[3]);
    unpack2(r.z, f[4], f[5]);
    unpack2(r.w, f[6], f[7]);
  }
  __device__ static uint4 pack(const float (&f)[kVec]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ void store16(void* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// packets [0, nvec), then single values [nvec·kVec, n)
template <typename E>
__global__ void __launch_bounds__(kThreads) gelu_erf_poly_elementwise_fwd_kernel(
    const E* __restrict__ x, E* __restrict__ y, int64_t n, int64_t nvec) {
  using io = Io<E>;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = first; i < nvec; i += stride) {
    float f[io::kVec];
    io::unpack(load16(x + i * io::kVec), f);
#pragma unroll
    for (int k = 0; k < io::kVec; ++k) f[k] = gelu_fwd(f[k]);
    store16(y + i * io::kVec, io::pack(f));
  }
  for (int64_t j = nvec * io::kVec + first; j < n; j += stride) {
    io::store1(y + j, gelu_fwd(io::load1(x + j)));
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads) gelu_erf_poly_elementwise_bwd_kernel(
    const E* __restrict__ x, const E* __restrict__ g, E* __restrict__ dx,
    int64_t n, int64_t nvec) {
  using io = Io<E>;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = first; i < nvec; i += stride) {
    float fx[io::kVec], fg[io::kVec];
    io::unpack(load16(x + i * io::kVec), fx);
    io::unpack(load16(g + i * io::kVec), fg);
#pragma unroll
    for (int k = 0; k < io::kVec; ++k) fx[k] = gelu_bwd(fx[k], fg[k]);
    store16(dx + i * io::kVec, io::pack(fx));
  }
  for (int64_t j = nvec * io::kVec + first; j < n; j += stride) {
    io::store1(dx + j, gelu_bwd(io::load1(x + j), io::load1(g + j)));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

// the packets a launch takes (none where a pointer is not 16-byte aligned)
// and its grid: one thread a packet or a leftover value, at most
// kBlocksPerSm blocks an SM
template <typename E>
void shape(int64_t n, bool aligned, int64_t& nvec, int& grid) {
  nvec = aligned ? n / Io<E>::kVec : 0;
  const int64_t work = std::max(nvec, n - nvec * Io<E>::kVec);
  grid = (int)std::min<int64_t>((work + kThreads - 1) / kThreads,
                                (int64_t)sm_count() * kBlocksPerSm);
}

template <typename E>
cudaError_t fwd(const void* x, void* y, int64_t n, cudaStream_t s) {
  int64_t nvec;
  int grid;
  shape<E>(n, aligned16(x) && aligned16(y), nvec, grid);
  gelu_erf_poly_elementwise_fwd_kernel<E><<<grid, kThreads, 0, s>>>(
      static_cast<const E*>(x), static_cast<E*>(y), n, nvec);
  return cudaGetLastError();
}

template <typename E>
cudaError_t bwd(const void* x, const void* g, void* dx, int64_t n,
                cudaStream_t s) {
  int64_t nvec;
  int grid;
  shape<E>(n, aligned16(x) && aligned16(g) && aligned16(dx), nvec, grid);
  gelu_erf_poly_elementwise_bwd_kernel<E><<<grid, kThreads, 0, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(g), static_cast<E*>(dx),
      n, nvec);
  return cudaGetLastError();
}

}  // namespace

// x and y: n values, contiguous on the device, f32 (bf16 == 0) or bf16
// (bf16 == 1).  Launches on `stream` (nothing for n == 0) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for n < 0.
extern "C" int gelu_erf_poly_fwd_launch(const void* x, void* y, int64_t n,
                                        int bf16, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? fwd<__nv_bfloat16>(x, y, n, s)
                             : fwd<float>(x, y, n, s);
  return static_cast<int>(e);
}

// x, g and dx: n values each, one type as above.  Same launch contract as
// gelu_erf_poly_fwd_launch.
extern "C" int gelu_erf_poly_bwd_launch(const void* x, const void* g, void* dx,
                                        int64_t n, int bf16, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? bwd<__nv_bfloat16>(x, g, dx, n, s)
                             : bwd<float>(x, g, dx, n, s);
  return static_cast<int>(e);
}
