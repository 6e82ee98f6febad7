// Exact per-row percentiles (numpy 'linear' method) for Hopper (sm_90a).
//
//   x (N, T) f32 -> out (N, n) f32,  out[i, q] = percentile(x[i], qs[q])
//
// Replaces the TPU kernel meg_decoding_tpu/ops/pallas/quantile.py
// (robust_quantiles, _kernel): the RobustScaler fit of the collate chain
// (25/50/75th percentiles of every (sample, channel) row over time).
//
// Semantics, identical to the TPU kernel:
// * floats map to sign-flipped int32 keys (b < 0 ? b ^ INT32_MAX : b), the
//   total order of XLA's float sort: -NaN < -inf < ... < -0 < +0 < ... <
//   +inf < +NaN;
// * each order statistic k = floor(q (T-1) / 100) is found EXACTLY by a
//   32-step bisection over the key space: the smallest key m with
//   count(keys <= m) >= k + 1;
// * the interpolation partner (order statistic k + 1) is the same key when
//   it is duplicated, else the smallest strictly greater key;
// * the blend v_lo * w_lo + v_hi * w_hi uses f32 weights rounded on the
//   host and is evaluated as fmaf(v_lo, w_lo, v_hi * w_hi) — the
//   contraction XLA applies to the JAX kernel's blend on the CPU — so the
//   result matches the reference bit for bit there.
//
// Bound on an H100 SXM (3.35 TB/s): one read of the input and a small
// write.  Collate of a Gwilliams serving batch, (B·C, T) = (13312, 360):
// 19.2 MB read + 0.16 MB written -> ~5.8 us.  An exact selection needs only
// a few operations per element, so the function is bound by bytes.
// Design: one warp per row; the row is read from global memory once,
// coalesced, into shared memory as keys; every bisection step is a strided
// pass over the keys in shared memory plus one warp-wide __reduce_add_sync.
// Nothing but the final values goes back to global memory.  The price of
// the bisection is its own floor above the byte bound: 3 x 33 passes over
// 360 keys per row are 474 M key visits (a shared-memory load, a compare
// and an add each), ~1.9 GB of shared-memory reads at ~33 TB/s and ~0.95 G
// integer operations at ~17 T/s (64 INT32 lanes per SM) -> ~57 us.  A radix
// select that visits each key a few times would lower it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

constexpr int kMaxQuantiles = 4;

// Per-quantile constants computed on the host (ops/kernels/quantile.py).
struct QuantileSpec {
  int n;                     // number of quantiles, <= kMaxQuantiles
  int rank[kMaxQuantiles];   // 0-based order statistic floor(q (T-1) / 100)
  int interp[kMaxQuantiles]; // 1 when q (T-1) / 100 has a fractional part
  float w_lo[kMaxQuantiles]; // f32(1 - frac)
  float w_hi[kMaxQuantiles]; // f32(frac)
};

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int flip(int b) { return b < 0 ? b ^ INT_MAX : b; }

__device__ __forceinline__ float unflip(int k) {
  return __int_as_float(k < 0 ? k ^ INT_MAX : k);
}

__global__ void robust_quantiles_kernel(const float* __restrict__ x,
                                        float* __restrict__ out, int N, int T,
                                        QuantileSpec spec) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= N) return;  // the whole warp leaves together; no block barrier
  int* keys = smem + warp * T;
  const float* xr = x + (int64_t)row * T;
  for (int t = lane; t < T; t += 32) keys[t] = flip(__float_as_int(xr[t]));
  __syncwarp();

  for (int q = 0; q < spec.n; ++q) {
    const int rank = spec.rank[q];
    int lo = INT_MIN, hi = INT_MAX;
    for (int it = 0; it < 32; ++it) {
      // overflow-safe floor((lo + hi) / 2)
      const int mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1);
      int c = 0;
      for (int t = lane; t < T; t += 32) c += keys[t] <= mid;
      c = __reduce_add_sync(kFull, c);
      if (c >= rank + 1) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const float v_lo = unflip(lo);
    float v = v_lo;
    if (spec.interp[q]) {
      int c = 0, nxt = INT_MAX;
      for (int t = lane; t < T; t += 32) {
        const int k = keys[t];
        c += k <= lo;
        if (k > lo && k < nxt) nxt = k;
      }
      c = __reduce_add_sync(kFull, c);
      nxt = __reduce_min_sync(kFull, nxt);
      const float v_hi = unflip(c >= rank + 2 ? lo : nxt);
      v = __fmaf_rn(v_lo, spec.w_lo[q], __fmul_rn(v_hi, spec.w_hi[q]));
    }
    if (lane == 0) out[(int64_t)row * spec.n + q] = v;
  }
}

}  // namespace

// x (N, T) f32 and out (N, spec->n) f32, contiguous on the device; `spec`
// points to host memory and is passed to the kernel by value.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// spec or row length the kernel does not take).
extern "C" int robust_quantiles_launch(const void* x, void* out, int N, int T,
                                       const QuantileSpec* spec,
                                       void* stream) {
  if (spec->n < 1 || spec->n > kMaxQuantiles || T < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  // 8 warps (rows) per CTA while their keys fit the default 48 KB of
  // shared memory; longer rows take fewer warps, then the opt-in maximum
  const size_t row_bytes = (size_t)T * sizeof(int);
  int warps = 8;
  while (warps > 1 && warps * row_bytes > 48 * 1024) warps >>= 1;
  const size_t smem = warps * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        robust_quantiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (N + warps - 1) / warps;
  robust_quantiles_kernel<<<grid, warps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), N, T, *spec);
  return static_cast<int>(cudaGetLastError());
}
