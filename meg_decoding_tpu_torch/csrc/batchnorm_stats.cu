// Per-channel statistics of training-mode BatchNorm for Hopper (sm_90a),
// on the port's NCW layout (channel = dim 1):
//
//   bn_stats:     x (B, C, T)                   -> out (2, C) f32 = [Σx, Σx²]
//   bn_bwd_stats: g, x (B, C, T); mean, invstd (C,) f32
//                                               -> out (2, C) f32 = [Σg, Σg·x̂]
//                 with x̂ = (x − mean)·invstd
//
// x and g are f32 or bf16 (both the same type); sums accumulate in f32.
//
// Replaces the TPU kernels of meg_decoding_tpu/ops/pallas/batchnorm.py:
// bn_stats (_stats_kernel) and bn_bwd_stats (_bwd_kernel), the statistics
// inside the batch_norm_train custom VJP.
//
// Bound on an H100 SXM (3.35 TB/s): each kernel reads its inputs once and
// does two or three flops per element, so bytes bound it.  At the training
// step's shape (64, 320, 360) f32: bn_stats reads 29.5 MB -> 8.8 us,
// bn_bwd_stats 59.0 MB -> 17.6 us (half of each in bf16).
//
// Design: the TPU kernel walks row blocks in order and carries the sums in
// a VMEM output from one grid step to the next.  Hopper blocks run in no
// order, so here one CTA owns one channel.  In NCW a channel is B rows of T
// contiguous values; the CTA's threads stride over them with 16-byte loads
// when every row starts 16-byte aligned (T·sizeof(elem) % 16 == 0 and an
// aligned base), else element by element, and accumulate in registers.
// A fixed-order reduction (warp shuffles, then the warps' partial sums in
// shared memory, added by one thread in warp order) finishes the sums: no
// atomics, so two launches on the same input give bit-identical sums.
// Loads stop at the end of each row, so nothing past the tensor is read and
// the TPU kernel's masking of padding rows has no counterpart here.
//
// Alternatives measured for bn_stats at (64, 320, 360) on an H100 SXM, all
// slower there than one CTA per channel (PERF.md): a thread-block cluster
// of 2, 4 or 8 CTAs per channel summed through distributed shared memory,
// 1,280 plain CTAs, row-tiled walks, fewer threads per CTA, and 2 to 4
// 16-byte loads in flight per thread.  The cluster split is faster only
// with fewer channels than two CTAs per SM (C = 1 or 24), which no ported
// model has (every ConvBlock's BN is 320 wide).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Elements per 16-byte load.
template <typename E>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Sums a and b over the CTA in a fixed order; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps];
  __shared__ float sb[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(kFull, a, o);
    b += __shfl_down_sync(kFull, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = sa[0];
    b = sb[0];
    for (int w = 1; w < kWarps; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const E* __restrict__ x, float* __restrict__ out, int B,
                    int C, int T, int vec) {
  const int c = blockIdx.x;
  float s = 0.f, ss = 0.f;
  if (vec) {
    constexpr int V = Vec<E>::n;
    const int tv = T / V;  // 16-byte vectors per row
    const int n = B * tv;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / tv;
      const int j = i - b * tv;
      float v[V];
      load16(x + ((int64_t)b * C + c) * T + (int64_t)j * V, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s += v[k];
        ss = fmaf(v[k], v[k], ss);
      }
    }
  } else {
    const int n = B * T;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / T;
      const int t = i - b * T;
      const float v = to_f32(x[((int64_t)b * C + c) * T + t]);
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  block_sum2(s, ss);
  if (threadIdx.x == 0) {
    out[c] = s;
    out[C + c] = ss;
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_stats_kernel(const E* __restrict__ g, const E* __restrict__ x,
                        const float* __restrict__ mean,
                        const float* __restrict__ invstd,
                        float* __restrict__ out, int B, int C, int T,
                        int vec) {
  const int c = blockIdx.x;
  const float mu = mean[c];
  const float is = invstd[c];
  float sg = 0.f, sgx = 0.f;
  if (vec) {
    constexpr int V = Vec<E>::n;
    const int tv = T / V;
    const int n = B * tv;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / tv;
      const int j = i - b * tv;
      const int64_t off = ((int64_t)b * C + c) * T + (int64_t)j * V;
      float gv[V], xv[V];
      load16(g + off, gv);
      load16(x + off, xv);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sg += gv[k];
        sgx = fmaf(gv[k], (xv[k] - mu) * is, sgx);
      }
    }
  } else {
    const int n = B * T;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int b = i / T;
      const int t = i - b * T;
      const int64_t off = ((int64_t)b * C + c) * T + t;
      const float gv = to_f32(g[off]);
      sg += gv;
      sgx = fmaf(gv, (to_f32(x[off]) - mu) * is, sgx);
    }
  }
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    out[c] = sg;
    out[C + c] = sgx;
  }
}

bool shape_ok(int B, int C, int T) {
  return B >= 1 && C >= 1 && T >= 1 && (int64_t)B * T <= INT_MAX;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x (B, C, T) contiguous on the device, f32 (bf16 == 0) or bf16 (bf16 == 1);
// out (2, C) f32.  Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int bn_stats_launch(const void* x, void* out, int B, int C, int T,
                               int bf16, void* stream) {
  if (!shape_ok(B, C, T)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  const int vec = (T % V == 0) && aligned16(x);
  if (bf16) {
    bn_stats_kernel<__nv_bfloat16><<<C, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), B, C,
        T, vec);
  } else {
    bn_stats_kernel<float><<<C, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), B, C, T, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// g and x (B, C, T) contiguous, one type (f32 or bf16 as above); mean and
// invstd (C,) f32; out (2, C) f32.  Same launch contract as bn_stats_launch.
extern "C" int bn_bwd_stats_launch(const void* g, const void* x,
                                   const void* mean, const void* invstd,
                                   void* out, int B, int C, int T, int bf16,
                                   void* stream) {
  if (!shape_ok(B, C, T)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int V = bf16 ? Vec<__nv_bfloat16>::n : Vec<float>::n;
  const int vec = (T % V == 0) && aligned16(g) && aligned16(x);
  if (bf16) {
    bn_bwd_stats_kernel<__nv_bfloat16><<<C, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(invstd),
        static_cast<float*>(out), B, C, T, vec);
  } else {
    bn_bwd_stats_kernel<float><<<C, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(x),
        static_cast<const float*>(mean), static_cast<const float*>(invstd),
        static_cast<float*>(out), B, C, T, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
