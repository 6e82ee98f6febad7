// Batched (recording, onset) window gather for Hopper (sm_90a).
//
//   out[b, c, :] = src[rec_ids[b], c, on_b : on_b + L],
//   on_b = clamp(onsets[b], 0, max_onset),  max_onset = T - padded_window(L)
//
// Replaces the TPU kernel meg_decoding_tpu/ops/pallas/window_gather.py
// (window_gather, _kernel): there a 128-lane-aligned DMA overfetch of each
// window plus a lane roll realigned the onset.  Hopper has no lane alignment,
// so this kernel reads the window directly.  The onset clamp keeps the TPU
// bound T - padded_window(L), not T - L, so an out-of-range onset selects the
// same window as the reference.
//
// Bound on an H100 SXM (3.35 TB/s): the work is a copy — every window element
// is read once and written once.  Gwilliams serving batch (B = 64, L = 360):
//   X  (208 channels, f32 -> f32):  2 x 19.2 MB = 38.3 MB -> ~11 us
//   Y  (1024 channels, f32 -> f32): 2 x 94.4 MB = 189 MB  -> ~56 us
//   Y  (1024 channels, f32 -> bf16): 94.4 + 47.2 MB       -> ~42 us
// Design against that bound: one CTA per (sample, tile of 16 channel rows),
// every thread moves 16-byte pieces (float4) of a row, so loads and stores
// are fully coalesced and the grid (832 CTAs for X, 4096 for Y) fills all
// 132 SMs.  The onset is arbitrary: each piece is assembled from the two
// aligned float4s that straddle it (the second one hits L1, it is the next
// thread's first), so every global load is an aligned 16-byte load and no
// unaligned head or tail remains.  The optional bf16 cast happens in
// registers before the store (8-byte stores).  A scalar variant covers
// shapes whose rows are not 16-byte aligned (T or L not a multiple of 4).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 16;

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);  // .x at the lower address
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// Requires T % 4 == 0, L % 4 == 0, src 16-byte and out 16- (f32) or 8-byte
// (bf16) aligned: every row start is then aligned too.
template <typename OutT>
__global__ void __launch_bounds__(kThreads) window_gather_vec4(
    const float* __restrict__ src, const int* __restrict__ rec_ids,
    const int* __restrict__ onsets, OutT* __restrict__ out, int R, int C,
    int T, int L, int max_onset) {
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, C - c0);
  const int rec = clamp_int(rec_ids[b], 0, R - 1);
  const int on = clamp_int(onsets[b], 0, max_onset);
  const int a = on & 3;  // misalignment of the window start, uniform per CTA
  const int n4 = L >> 2;
  // aligned base of the window; the window ends at least 127 samples
  // before the row does (max_onset = T - padded_window(L)), so the second
  // float4 of the last piece stays inside the row
  const float* base = src + ((int64_t)rec * C + c0) * T + (on - a);
  OutT* dst = out + ((int64_t)b * C + c0) * L;
  for (int i = threadIdx.x; i < rows * n4; i += kThreads) {
    const int r = i / n4;
    const int j = i - r * n4;
    const float4* p = reinterpret_cast<const float4*>(base + (int64_t)r * T) + j;
    const float4 v0 = __ldg(p);
    float4 v;
    if (a == 0) {
      v = v0;
    } else {
      const float4 v1 = __ldg(p + 1);
      if (a == 1) {
        v = make_float4(v0.y, v0.z, v0.w, v1.x);
      } else if (a == 2) {
        v = make_float4(v0.z, v0.w, v1.x, v1.y);
      } else {
        v = make_float4(v0.w, v1.x, v1.y, v1.z);
      }
    }
    store4(dst + (int64_t)r * L + 4 * j, v);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) window_gather_scalar(
    const float* __restrict__ src, const int* __restrict__ rec_ids,
    const int* __restrict__ onsets, OutT* __restrict__ out, int R, int C,
    int T, int L, int max_onset) {
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, C - c0);
  const int rec = clamp_int(rec_ids[b], 0, R - 1);
  const int on = clamp_int(onsets[b], 0, max_onset);
  const float* base = src + ((int64_t)rec * C + c0) * T + on;
  OutT* dst = out + ((int64_t)b * C + c0) * L;
  for (int i = threadIdx.x; i < rows * L; i += kThreads) {
    const int r = i / L;
    const int t = i - r * L;
    store1(dst + (int64_t)r * L + t, __ldg(base + (int64_t)r * T + t));
  }
}

template <typename OutT>
void launch(const float* src, const int* rec_ids, const int* onsets, OutT* out,
            int R, int C, int T, int B, int L, int max_onset,
            cudaStream_t stream) {
  const dim3 grid((C + kRowsPerBlock - 1) / kRowsPerBlock, B);
  const uintptr_t out_align = sizeof(OutT) == 4 ? 16 : 8;
  const bool vec = (T % 4 == 0) && (L % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % out_align == 0);
  if (vec) {
    window_gather_vec4<OutT><<<grid, kThreads, 0, stream>>>(
        src, rec_ids, onsets, out, R, C, T, L, max_onset);
  } else {
    window_gather_scalar<OutT><<<grid, kThreads, 0, stream>>>(
        src, rec_ids, onsets, out, R, C, T, L, max_onset);
  }
}

}  // namespace

// src (R, C, T) f32, rec_ids (B,) int32, onsets (B,) int32, out (B, C, L)
// f32 (out_bf16 = 0) or bf16 (out_bf16 = 1), all contiguous on the device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int window_gather_launch(const void* src, const void* rec_ids,
                                    const void* onsets, void* out, int R,
                                    int C, int T, int B, int L, int max_onset,
                                    int out_bf16, void* stream) {
  if (B == 0 || C == 0 || L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(src);
  const int* ids = static_cast<const int*>(rec_ids);
  const int* ons = static_cast<const int*>(onsets);
  if (out_bf16) {
    launch(x, ids, ons, static_cast<__nv_bfloat16*>(out), R, C, T, B, L,
           max_onset, s);
  } else {
    launch(x, ids, ons, static_cast<float*>(out), R, C, T, B, L, max_onset, s);
  }
  return static_cast<int>(cudaGetLastError());
}
