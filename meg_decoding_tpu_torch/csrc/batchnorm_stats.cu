// Training-mode BatchNorm for Hopper (sm_90a), on the port's NCW layout
// (channel = dim 1):
//
//   bn_stats:     x (B, C, T)                   -> out (2, C) f32 = [Σx, Σx²]
//   bn_bwd_stats: g, x (B, C, T); mean, invstd (C,) f32
//                                               -> out (2, C) f32 = [Σg, Σg·x̂]
//                 with x̂ = (x − mean)·invstd
//   bn_bwd:       the same sums and the layer's input gradient
//                 dx = (scale·invstd)·(g − Σg/M − x̂·Σg·x̂/M)
//                      [+ gmean/M] [+ gvar·2·(x − mean)/M],   M = B·T
//   bn_bwd_dx:    that dx from sums and an M given by the caller: synced
//                 BatchNorm under data parallelism, where bn_bwd_stats's
//                 sums are all-reduced over the ranks first and M is the
//                 global B·T (ops/batchnorm.py)
//
// x and g are f32 or bf16 (both the same type); sums and dx are computed in
// f32, dx rounded once to x's type.
//
// Replaces the TPU kernels of meg_decoding_tpu/ops/pallas/batchnorm.py:
// bn_stats (_stats_kernel, :69) and bn_bwd_stats (_bwd_kernel, :111), the
// statistics inside the batch_norm_train custom VJP.  bn_bwd also stands for
// the dx that the custom VJP computes from the sums (_bn_bwd, :231-236),
// which XLA fuses into one pass right after the Pallas kernel.
//
// Bounds on an H100 SXM (3.35 TB/s): each kernel does a few flops per
// element, so bytes bound it.  At the training step's shape (64, 320, 360)
// f32: bn_stats reads 29.5 MB -> 8.8 us, bn_bwd_stats 59.0 MB -> 17.6 us,
// bn_bwd reads g and x and writes dx, 88.5 MB -> 26.4 us (half of each in
// bf16).  bn_bwd_stats is bn_bwd without dx.
//
// The TPU kernels walk row blocks in order and carry the sums in a VMEM
// output from one grid step to the next.  Hopper blocks run in no order, so
// here a channel's sums belong to one CTA or one thread-block cluster: in
// NCW a channel is B rows of T contiguous values, which the threads stride
// over with 16-byte loads when every row starts 16-byte aligned
// (T·sizeof(elem) % 16 == 0 and aligned bases), else element by element.
// A fixed-order reduction (warp shuffles, then the warps' partial sums in
// shared memory, then a cluster's CTAs in rank order) finishes the sums: no
// atomics, so two launches on the same input give bit-identical sums and
// dx.  Loads stop at the end of each row, so nothing past the tensor is
// read and the TPU kernels' masking of padding rows has no counterpart.
//
// bn_stats takes one of two routes, picked by stats_route from the channel
// count C and a channel's n = B·T/V loads (V values a load, or one element
// a load where rows are not 16-byte aligned), with the SM count read once:
// - cluster (n > kThreads·kStatsUnroll and C under two CTAs per SM, as
//   EEGNet's bn1 (64, 16, 528), where one CTA per channel left 16 of 132
//   SMs working): a thread-block cluster of k = 2…8 CTAs per channel, so
//   that C·k CTAs cover the SMs; each thread keeps up to kStatsUnroll loads
//   in flight, and each CTA writes its sums into rank 0's shared memory
//   (distributed shared memory), which adds them in cluster-rank order.
//   One launch, no float atomics.  Rank 0 reading the sums from the other
//   CTAs' shared memory after a second barrier was slower.
// - per_channel (every other shape: the speech step's (64, 320, 360) f32
//   and bf16, the presets' (256, 320, 360) bf16, GOD's (64, 320, 24),
//   EEGNet's bn2/bn3 and Seq2Static's T = 48 … 2): one CTA of kThreads per
//   channel, one load in flight per thread.  Measured slower than it at
//   (64, 320, 360) (PERF.md): a cluster of 2, 4 or 8 CTAs per channel,
//   1,280 plain CTAs, row-tiled walks, fewer threads per CTA, 2 to 4 loads
//   in flight per thread.  At n <= kThreads (one load a thread) a narrower
//   CTA, a serial or a tree sum of the warps, a warp per channel (8 or 16
//   loads a lane) and the cluster route were no faster: there the launch
//   and one round trip to device memory set the time, not the idle
//   threads.  Between one and kStatsUnroll loads a thread, one CTA per
//   channel as narrow as the channel needs with all its loads in flight
//   was as fast at (64, 320, 48) f32 and 0.2-0.3 us (5 %) faster at the
//   unaligned (64, 320, 23) and (64, 320, 11) on an NVIDIA H100 80GB HBM3
//   at 700 W (PERF.md): too little for a third route.
// The cluster route walks a thread's loads without a division and ends
// with a shuffle tree over the warps' sums.

// bn_bwd keeps g and x out of a second trip through device memory: dx
// needs both sums, which need all of the channel, so a plain pair of
// kernels reads g and x twice (59 MB more at the training shape in f32).
// Two kernels, picked by the launcher:
// - bn_bwd_reg_kernel (f32): the channel's g and x in registers.  One
//   channel is 2·B·T·4 = 184,320 B at (64, ·, 360), inside an SM's 256 KB
//   register file: kBwdMaxSlots = 12 16-byte slots of each a thread of 512.
//   A persistent grid, one CTA per SM, each taking channels c, c + grid, …;
//   as a thread stores slot m's dx it loads slot m of its next channel, so
//   that channel's loads stream while this one's stores leave.  g and x
//   cross device memory once, dx once.
// - bn_bwd_l2_kernel (bf16, every shape the register kernel does not take,
//   and the sums alone): one CTA per channel walks it twice, the second
//   time (dx) in reverse, so it re-reads from the 50 MB L2 what the first
//   walk (the sums) brought in last; the second walk's loads and the dx
//   stores are marked evict-first.  At (64, 320, 360) bf16, g and x are
//   29.5 MB, under the L2's 50 MB, so the second walk should find them
//   there and device memory see them about once: reckoned from the sizes,
//   not traced.  Where they do not fit, the second walk goes back to device
//   memory: two passes.
// Per call in a run of 64 at (64, 320, 360) on an NVIDIA H100 80GB HBM3 at
// 700 W: f32 38.7-39.9 us (bound 26.4), bf16 20.9-21.3 us (bound 13.2)
// (chip_smoke.py, run_ms).  Designs measured on drafts of this source and
// not kept (PERF.md):
// the channel in dynamic shared memory loaded by TMA bulk copies of one row
// each, one CTA or a cluster of 2 or 4 per channel, with or without a
// persistent double-buffered grid (f32 42-61 us, bf16 27-60 us); the
// register kernel on clusters of 2 or 4, or double-buffered; the two-walk
// kernel for f32 (45-49 us), unrolled, persistent or with an evict-last
// policy on its first walk; and bf16 in registers (26-30 us).
//
// bn_bwd_dx is elementwise and streams: it reads g and x and writes dx
// once, 88.5 MB at the training shape in f32 -> 26.4 us bound (bytes), like
// bn_bwd, which the split route (sums, all-reduce, dx) replaces under a
// process group.  CTA (c, tile) takes one tile of channel c's loads; each
// thread issues its dx_loads(V) loads of g and of x (evict-first: each
// line is read once) before it reads the channel's constants, so their
// round trip overlaps the stream, walks its rows without a division and
// stores dx evict-first.  The tiles a channel are the fewest that keep a
// thread within its loads, or more where C channels leave SMs idle, up to
// one wave of kDxBlocksPerSm CTAs on every SM.  Tried on drafts of this
// source and not kept: 32 values a thread (2 CTAs an SM), 8 values (8 CTAs an SM), 6
// CTAs an SM (registers spill), 128-thread CTAs, plain loads and stores,
// 4 bf16 loads a thread (registers spill), and a walk of the whole tensor
// in memory order with each load's constants computed per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// bn_bwd: threads per CTA, and the 16-byte registers a thread gives each of
// g and x in the register kernel (f32 only; bf16 takes the two-walk
// kernel: measured faster, PERF.md).
constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxSlots = 12;

// bn_stats' cluster route: the loads a thread keeps in flight, and the
// most CTAs a cluster gives one channel (the portable cluster size).
constexpr int kStatsUnroll = 4;
constexpr int kMaxCluster = 8;

// bn_bwd_dx: threads per CTA, the values a thread takes (all its loads in
// flight at once), and the CTAs an SM holds at once (its launch bound: at
// most 64 registers a thread).
constexpr int kDxThreads = 256;
constexpr int kDxElems = 16;
constexpr int kDxBlocksPerSm = 4;
constexpr int kMaxGridY = 65535;

// bn_bwd_dx's loads of each of g and x a thread: kDxElems values in 16-byte
// loads, or 4 single elements where rows are not 16-byte aligned (16 would
// spill past the 64 registers).
__host__ __device__ constexpr int dx_loads(int V) {
  return V == 1 ? 4 : kDxElems / V;
}

namespace cg = cooperative_groups;

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

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The V values of 16 raw bytes.
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const float& e, float (&v)[1]) {
  v[0] = e;
}

__device__ __forceinline__ void unpack(const __nv_bfloat16& e, float (&v)[1]) {
  v[0] = __bfloat162float(e);
}

template <int V, typename E>
__device__ __forceinline__ void load16(const E* p, float (&v)[V]) {
  unpack(ld16(p), v);
}

// The raw bits of V values at p (one 16-byte load, or V == 1 one element),
// unpacked later, so that a thread issues all its loads before it uses one.
// CS: a streaming 16-byte load (ld.global.cs, evict first).
template <typename E, int V>
struct Raw {
  using type = uint4;
};
template <typename E>
struct Raw<E, 1> {
  using type = E;
};

template <int V, bool CS = false, typename E>
__device__ __forceinline__ typename Raw<E, V>::type ldraw(const E* p) {
  if constexpr (V == 1) {
    return *p;
  } else if constexpr (CS) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  } else {
    return ld16(p);
  }
}

// V values at p: one 16-byte load, or (V == 1) one element.  CS: a
// streaming load (ld.global.cs, evict first), for a line read the last time.
template <int V, bool CS = false, typename E>
__device__ __forceinline__ void loadv(const E* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f32(*p);
  } else if constexpr (CS) {
    unpack(__ldcs(reinterpret_cast<const uint4*>(p)), v);
  } else {
    load16(p, v);
  }
}

// V values to p, rounded once to E.  CS: a streaming store (st.global.cs).
template <int V, bool CS = false>
__device__ __forceinline__ void storev(float* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else {
    const float4 q = make_float4(v[0], v[1], v[2], v[3]);
    if constexpr (CS) {
      __stcs(reinterpret_cast<float4*>(p), q);
    } else {
      *reinterpret_cast<float4*>(p) = q;
    }
  }
}

template <int V, bool CS = false>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (CS) {
      __stcs(reinterpret_cast<uint4*>(p), q);
    } else {
      *reinterpret_cast<uint4*>(p) = q;
    }
  }
}

// Sums a and b over the CTA of W warps in a fixed order; thread 0 holds the
// result.
template <int W>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[W];
  __shared__ float sb[W];
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
    for (int w = 1; w < W; ++w) {
      a += sa[w];
      b += sb[w];
    }
  }
}

// Sums a and b over the CTA's blockDim.x / 32 warps (blockDim.x a multiple
// of 32) in a fixed order: each warp's shuffle-down tree, then warp 0's
// shuffle-down tree over the warps' sums.  Thread 0 holds the result.
__device__ __forceinline__ void block_sum2_tree(float& a, float& b) {
  __shared__ float sa[32];
  __shared__ float sb[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(kFull, a, o);
    b += __shfl_down_sync(kFull, b, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? sa[lane] : 0.f;
    b = lane < nw ? sb[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(kFull, a, o);
      b += __shfl_down_sync(kFull, b, o);
    }
  }
}

// bn_stats, per_channel route.
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
  block_sum2<kWarps>(s, ss);
  if (threadIdx.x == 0) {
    out[c] = s;
    out[C + c] = ss;
  }
}

// --- bn_bwd ------------------------------------------------------------------

struct BwdArgs {
  const float* scale;
  const float* mean;
  const float* invstd;
  const float* gmean;  // null: no mean cotangent
  const float* gvar;   // null: no var cotangent
  float* out;          // (2, C): [Σg, Σg·x̂]
  int B, C, T;
  float M;             // the count the mean is over: B·T, or the global B·T
};

// Per-channel constants of dx, from the channel's two sums.
struct DxCoef {
  float mu, is, a, k1, k2, gm, gv2, M;
  bool has_gm, has_gv;
};

__device__ __forceinline__ DxCoef dx_coef(const BwdArgs& p, int c, float sg,
                                          float sgx) {
  DxCoef k;
  k.M = p.M;
  k.mu = p.mean[c];
  k.is = p.invstd[c];
  k.a = __fmul_rn(p.scale[c], k.is);
  k.k1 = __fdiv_rn(sg, k.M);
  k.k2 = __fdiv_rn(sgx, k.M);
  k.has_gm = p.gmean != nullptr;
  k.has_gv = p.gvar != nullptr;
  k.gm = k.has_gm ? __fdiv_rn(p.gmean[c], k.M) : 0.f;
  k.gv2 = k.has_gv ? __fmul_rn(p.gvar[c], 2.f) : 0.f;
  return k;
}

// dx of one element in the order of the plain version (ops/kernels/
// batchnorm.py:bn_bwd_plain), each step rounded on its own (no fma).
__device__ __forceinline__ float dx_of(float g, float x, const DxCoef& k) {
  const float xc = __fsub_rn(x, k.mu);
  const float xhat = __fmul_rn(xc, k.is);
  float d = __fmul_rn(k.a, __fsub_rn(__fsub_rn(g, k.k1), __fmul_rn(xhat, k.k2)));
  if (k.has_gm) d = __fadd_rn(d, k.gm);
  if (k.has_gv) d = __fadd_rn(d, __fdiv_rn(__fmul_rn(k.gv2, xc), k.M));
  return d;
}

// Registers (f32): persistent, CTA q of n takes channels q, q + n, …; each
// channel's tv = T / V 16-byte vectors a row are numbered i = row·tv + col,
// and thread t holds vectors t + m·kBwdThreads (m < NV) of g and x in
// registers, slots past the channel's vectors unused.  After a channel's
// sums, each thread writes slot m's dx and at once loads slot m of the
// CTA's next channel.
__global__ void __launch_bounds__(kBwdThreads, 1)
    bn_bwd_reg_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      float* __restrict__ dx, BwdArgs p) {
  __shared__ float tot[2];
  constexpr int V = Vec<float>::n;
  constexpr int NV = kBwdMaxSlots;
  const int C = p.C, T = p.T, tv = T / V;
  const int n = p.B * tv;
  auto offset = [&](int m, int c) {
    const int i = (int)threadIdx.x + m * kBwdThreads;
    const int row = i / tv, col = i - row * tv;
    return ((int64_t)row * C + c) * T + (int64_t)col * V;
  };
  uint4 gr[NV], xr[NV];
#pragma unroll
  for (int m = 0; m < NV; ++m) {
    if ((int)threadIdx.x + m * kBwdThreads < n) {
      const int64_t o = offset(m, blockIdx.x);
      gr[m] = ld16(g + o);
      xr[m] = ld16(x + o);
    }
  }
  for (int c = blockIdx.x; c < C; c += gridDim.x) {
    const float mu = p.mean[c];
    const float is = p.invstd[c];
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      if ((int)threadIdx.x + m * kBwdThreads < n) {
        float gv[V], xv[V];
        unpack(gr[m], gv);
        unpack(xr[m], xv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sg += gv[e];
          sgx = fmaf(gv[e], (xv[e] - mu) * is, sgx);
        }
      }
    }
    block_sum2<kBwdWarps>(sg, sgx);
    if (threadIdx.x == 0) {
      p.out[c] = tot[0] = sg;
      p.out[C + c] = tot[1] = sgx;
    }
    __syncthreads();
    const DxCoef k = dx_coef(p, c, tot[0], tot[1]);
    const int next = c + gridDim.x;
#pragma unroll
    for (int m = 0; m < NV; ++m) {
      if ((int)threadIdx.x + m * kBwdThreads < n) {
        float gv[V], xv[V], d[V];
        unpack(gr[m], gv);
        unpack(xr[m], xv);
#pragma unroll
        for (int e = 0; e < V; ++e) d[e] = dx_of(gv[e], xv[e], k);
        storev<V>(dx + offset(m, c), d);
        if (next < C) {
          const int64_t o = offset(m, next);
          gr[m] = ld16(g + o);
          xr[m] = ld16(x + o);
        }
      }
    }
  }
}

// (row, col) one thread-stride (kBwdThreads vectors) on, or back.
__device__ __forceinline__ void step_on(int& row, int& col, int drow, int dcol,
                                        int tv) {
  row += drow;
  col += dcol;
  if (col >= tv) {
    col -= tv;
    ++row;
  }
}

__device__ __forceinline__ void step_back(int& row, int& col, int drow,
                                          int dcol, int tv) {
  row -= drow;
  col -= dcol;
  if (col < 0) {
    col += tv;
    --row;
  }
}

// Two walks: one CTA per channel.  The sums: thread t on vectors t,
// t + kBwdThreads, … of the channel's B·T / V (rows stepped without a
// division).  Then dx over the same vectors in reverse, so the lines the
// first walk brought into the L2 last are read first; these loads and the
// dx stores stream (evict first), leaving the L2 to the lines still to be
// re-read.  dx == null: the sums only.
template <typename E, int V>
__global__ void __launch_bounds__(kBwdThreads)
    bn_bwd_l2_kernel(const E* __restrict__ g, const E* __restrict__ x,
                     E* __restrict__ dx, BwdArgs p) {
  __shared__ float tot[2];
  const int c = blockIdx.x, C = p.C, T = p.T, tv = T / V;
  const int n = p.B * tv;
  const int drow = kBwdThreads / tv, dcol = kBwdThreads % tv;
  const float mu = p.mean[c];
  const float is = p.invstd[c];
  float sg = 0.f, sgx = 0.f;
  int row = threadIdx.x / tv, col = threadIdx.x % tv, i = threadIdx.x;
  for (; i < n; i += kBwdThreads) {
    const int64_t o = ((int64_t)row * C + c) * T + (int64_t)col * V;
    float gv[V], xv[V];
    loadv<V>(g + o, gv);
    loadv<V>(x + o, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sg += gv[e];
      sgx = fmaf(gv[e], (xv[e] - mu) * is, sgx);
    }
    step_on(row, col, drow, dcol, tv);
  }
  block_sum2<kBwdWarps>(sg, sgx);
  if (threadIdx.x == 0) {
    p.out[c] = tot[0] = sg;
    p.out[C + c] = tot[1] = sgx;
  }
  if (dx == nullptr) return;
  __syncthreads();
  const DxCoef k = dx_coef(p, c, tot[0], tot[1]);
  // i, row and col are one stride past the thread's last vector
  for (i -= kBwdThreads; i >= 0; i -= kBwdThreads) {
    step_back(row, col, drow, dcol, tv);
    const int64_t o = ((int64_t)row * C + c) * T + (int64_t)col * V;
    float gv[V], xv[V], d[V];
    loadv<V, true>(g + o, gv);
    loadv<V, true>(x + o, xv);
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = dx_of(gv[e], xv[e], k);
    storev<V, true>(dx + o, d);
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

int pow2_floor(int64_t v) {
  int p = 1;
  while (p <= INT_MAX / 2 && 2 * (int64_t)p <= v) p *= 2;
  return p;
}

// --- bn_stats: the cluster route ----------------------------------------

// Σx and Σx² of one channel's loads first, first + stride, … < n, the
// channel being rows of tv loads, row r at xc + r·rs elements; the loads U
// at a time, issued together, then added in the walk's order.
template <int U, int V, typename E>
__device__ __forceinline__ void stats_walk(const E* __restrict__ xc,
                                           int64_t rs, int tv, int n,
                                           int first, int stride, float& s,
                                           float& ss) {
  const int drow = stride / tv, dcol = stride - drow * tv;
  int row = first / tv, col = first - row * tv;
  for (int64_t i = first; i < n; i += (int64_t)U * stride) {
    typename Raw<E, V>::type r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((int64_t)u * stride < n - i) {
        r[u] = ldraw<V>(xc + row * rs + (int64_t)col * V);
      }
      if (u + 1 < U) step_on(row, col, drow, dcol, tv);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if ((int64_t)u * stride < n - i) {
        float v[V];
        unpack(r[u], v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s += v[e];
          ss = fmaf(v[e], v[e], ss);
        }
      }
    }
    step_on(row, col, drow, dcol, tv);
  }
}

// The cluster barrier in halves: arrive without ordering memory, and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// Cluster route: grid C·k, clusters of k; the cluster's CTA of rank r
// takes channel blockIdx.x / k's loads r·kThreads + t, then k·kThreads on,
// and writes its two sums into rank 0's shared memory, which adds the k
// pairs in rank order.  The first barrier (every CTA of the cluster has
// started, so rank 0's shared memory exists) is arrived at before the
// loads and waited for after them.
template <typename E, int V, int U>
__global__ void __launch_bounds__(kThreads)
    bn_stats_cluster_kernel(const E* __restrict__ x, float* __restrict__ out,
                            int B, int C, int T, int k) {
  __shared__ float parts[2 * kMaxCluster];
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int c = blockIdx.x / k, tv = T / V;
  float s = 0.f, ss = 0.f;
  stats_walk<U, V>(x + (int64_t)c * T, (int64_t)C * T, tv, B * tv,
                   r * kThreads + (int)threadIdx.x, k * kThreads, s, ss);
  block_sum2_tree(s, ss);
  cluster_wait();
  if (threadIdx.x == 0) {
    float* dst = cluster.map_shared_rank(parts, 0);
    dst[2 * r] = s;
    dst[2 * r + 1] = ss;
  }
  cluster.sync();  // the k pairs are in rank 0's shared memory
  if (r == 0 && threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int q = 0; q < k; ++q) {
      a += parts[2 * q];
      b += parts[2 * q + 1];
    }
    out[c] = a;
    out[C + c] = b;
  }
}

enum StatsRoute { kPerChannel = 0, kCluster = 1 };

// A channel's loads: B·T/V when rows are 16-byte aligned (vec), else B·T.
int64_t stats_loads(int B, int T, int V, bool vec) {
  return (int64_t)B * (vec ? T / V : T);
}

// The launcher's rule, from a channel's n loads: past kStatsUnroll loads a
// thread of a CTA, the cluster route when there are fewer channels than
// two CTAs per SM; else one CTA per channel.
int stats_route(int C, int64_t n, int sms) {
  return n > (int64_t)kThreads * kStatsUnroll && C < 2 * sms ? kCluster
                                                             : kPerChannel;
}

// CTAs a channel on the cluster route: enough for C·k to reach two CTAs
// per SM, no more than a CTA of kThreads loads a channel, within 2…8.
int cluster_size(int C, int64_t n, int sms) {
  const int k = std::min(pow2_floor(2 * sms / C), pow2_floor(n / kThreads));
  return std::max(2, std::min(kMaxCluster, k));
}

// Loads a thread at most: n over `threads` threads, within 1…kStatsUnroll.
int loads_per_thread(int64_t n, int64_t threads) {
  return (int)std::min<int64_t>(
      kStatsUnroll, std::max<int64_t>(1, (n + threads - 1) / threads));
}

// f(std::integral_constant<int, U>) for U the least of 1, 2, 4 >= u.
template <typename F>
cudaError_t with_unroll(int u, F&& f) {
  if (u <= 1) return f(std::integral_constant<int, 1>());
  if (u <= 2) return f(std::integral_constant<int, 2>());
  return f(std::integral_constant<int, 4>());
}

template <typename E, int V>
cudaError_t launch_cluster(const E* x, float* out, int B, int C, int T,
                           int64_t n, cudaStream_t s) {
  const int k = cluster_size(C, n, sm_count());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * k);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = with_unroll(
      loads_per_thread(n, (int64_t)k * kThreads), [&](auto u) {
        return cudaLaunchKernelEx(
            &cfg, bn_stats_cluster_kernel<E, V, decltype(u)::value>, x, out,
            B, C, T, k);
      });
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch reports it
    return e;
  }
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_stats(const E* x, float* out, int B, int C, int T,
                         int route, int* taken, cudaStream_t s) {
  constexpr int V = Vec<E>::n;
  const int vec = (T % V == 0) && aligned16(x);
  const int64_t n = stats_loads(B, T, V, vec);
  if (route < 0) route = stats_route(C, n, sm_count());
  if (taken != nullptr) *taken = route;
  if (route == kPerChannel) {
    bn_stats_kernel<E><<<C, kThreads, 0, s>>>(x, out, B, C, T, vec);
    return cudaGetLastError();
  }
  if (route != kCluster) return cudaErrorInvalidValue;
  return vec ? launch_cluster<E, V>(x, out, B, C, T, n, s)
             : launch_cluster<E, 1>(x, out, B, C, T, n, s);
}

// --- bn_bwd_dx ---------------------------------------------------------------

// dx from given sums (2, C) = [Σg, Σg·x̂] and p.M.  CTA (c, tile) of grid
// (C, tiles) takes loads [tile·len, min(n, (tile + 1)·len)) of channel c's
// n; thread t the loads tile·len + t + u·kDxThreads (u < U = dx_loads(V)),
// its g and x all issued before the channel's constants are read.
template <typename E, int V>
__global__ void __launch_bounds__(kDxThreads, kDxBlocksPerSm)
    bn_bwd_dx_kernel(const E* __restrict__ g, const E* __restrict__ x,
                     E* __restrict__ dx, const float* __restrict__ sums,
                     BwdArgs p, int len) {
  constexpr int U = dx_loads(V);
  const int c = blockIdx.x, tv = p.T / V;
  const int i0 = blockIdx.y * len;
  // this thread's loads are u·kDxThreads < left
  const int left = min(p.B * tv - i0, len) - (int)threadIdx.x;
  const int first = i0 + (int)threadIdx.x;
  const int drow = kDxThreads / tv, dcol = kDxThreads - drow * tv;
  const int64_t rs = (int64_t)p.C * p.T, base = (int64_t)c * p.T;
  int row = first / tv, col = first - row * tv;
  typename Raw<E, V>::type gr[U], xr[U];
  int64_t off[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    off[u] = row * rs + base + (int64_t)col * V;
    if (u * kDxThreads < left) {
      gr[u] = ldraw<V, true>(g + off[u]);
      xr[u] = ldraw<V, true>(x + off[u]);
    }
    if (u + 1 < U) step_on(row, col, drow, dcol, tv);
  }
  const DxCoef k = dx_coef(p, c, sums[c], sums[p.C + c]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u * kDxThreads < left) {
      float gv[V], xv[V], d[V];
      unpack(gr[u], gv);
      unpack(xr[u], xv);
#pragma unroll
      for (int e = 0; e < V; ++e) d[e] = dx_of(gv[e], xv[e], k);
      storev<V, true>(dx + off[u], d);
    }
  }
}

// Tiles a channel of n loads, U a thread: the fewest that keep a thread
// within U loads, or, where C channels leave SMs idle, as many as fill one
// wave of kDxBlocksPerSm CTAs an SM, but no tile under kDxThreads loads.
// The tiles are the grid's y (channels its x, up to 2^31 - 1), which takes
// at most kMaxGridY: a channel of more than kMaxGridY·kDxThreads·U loads
// (B·T over 268 M values in f32) is refused with cudaErrorInvalidValue.
int dx_tiles(int64_t n, int C, int sms, int U) {
  const int64_t per = (int64_t)kDxThreads * U;
  const int64_t least = (n + per - 1) / per;
  const int64_t most = (n + kDxThreads - 1) / kDxThreads;
  const int64_t fill = (int64_t)sms * kDxBlocksPerSm / C;
  return (int)std::max(least, std::min(fill, most));
}

template <typename E>
cudaError_t launch_dx(const void* g, const void* x, void* dx,
                      const float* sums, const BwdArgs& p, cudaStream_t s) {
  constexpr int V = Vec<E>::n;
  const bool vec =
      p.T % V == 0 && aligned16(g) && aligned16(x) && aligned16(dx);
  const int n = p.B * (vec ? p.T / V : p.T);
  const int tiles = dx_tiles(n, p.C, sm_count(), dx_loads(vec ? V : 1));
  if (tiles > kMaxGridY) return cudaErrorInvalidValue;
  const int len = (int)(((int64_t)n + tiles - 1) / tiles);
  const dim3 grid(p.C, tiles);
  const E* ge = static_cast<const E*>(g);
  const E* xe = static_cast<const E*>(x);
  E* de = static_cast<E*>(dx);
  if (vec) {
    bn_bwd_dx_kernel<E, V><<<grid, kDxThreads, 0, s>>>(ge, xe, de, sums, p,
                                                        len);
  } else {
    bn_bwd_dx_kernel<E, 1><<<grid, kDxThreads, 0, s>>>(ge, xe, de, sums, p,
                                                        len);
  }
  return cudaGetLastError();
}

bool shape_ok(int B, int C, int T) {
  return B >= 1 && C >= 1 && T >= 1 && (int64_t)B * T <= INT_MAX;
}


template <typename E>
cudaError_t launch_l2(const E* g, const E* x, E* dx, const BwdArgs& p,
                      cudaStream_t s) {
  constexpr int V = Vec<E>::n;
  const bool aligned = p.T % V == 0 && aligned16(g) && aligned16(x) &&
                       (dx == nullptr || aligned16(dx));
  if (aligned) {
    bn_bwd_l2_kernel<E, V><<<p.C, kBwdThreads, 0, s>>>(g, x, dx, p);
  } else {
    bn_bwd_l2_kernel<E, 1><<<p.C, kBwdThreads, 0, s>>>(g, x, dx, p);
  }
  return cudaGetLastError();
}

cudaError_t launch_reg(const float* g, const float* x, float* dx,
                       const BwdArgs& p, cudaStream_t s) {
  bn_bwd_reg_kernel<<<std::min(p.C, sm_count()), kBwdThreads, 0, s>>>(g, x,
                                                                      dx, p);
  return cudaGetLastError();
}

// f32 with dx: the register kernel when rows are 16-byte aligned and a
// thread's share of a channel fits kBwdMaxSlots slots; else, and for bf16
// and for the sums alone, the two-walk kernel.
template <typename E>
cudaError_t launch_bwd(const E* g, const E* x, E* dx, const BwdArgs& p,
                       cudaStream_t s) {
  constexpr int V = Vec<E>::n;
  if constexpr (std::is_same_v<E, float>) {
    const bool aligned = p.T % V == 0 && aligned16(g) && aligned16(x) &&
                         aligned16(dx);
    const int64_t need =
        ((int64_t)p.B * (p.T / V) + kBwdThreads - 1) / kBwdThreads;
    if (dx != nullptr && aligned && need <= kBwdMaxSlots) {
      return launch_reg(g, x, dx, p, s);
    }
  }
  return launch_l2<E>(g, x, dx, p, s);
}

template <typename E>
cudaError_t bwd(const void* g, const void* x, void* dx, const BwdArgs& p,
                cudaStream_t s) {
  return launch_bwd<E>(static_cast<const E*>(g), static_cast<const E*>(x),
                       static_cast<E*>(dx), p, s);
}

}  // namespace

// x (B, C, T) contiguous on the device, f32 (bf16 == 0) or bf16 (bf16 == 1);
// out (2, C) f32.  route: -1 the launcher's pick (stats_route), else 0
// per_channel or 1 cluster (either takes any shape); the route
// launched goes to *taken (unless taken is null).  Launches on `stream` and
// returns cudaGetLastError(), or the cluster launch's own error
// (cudaErrorInvalidValue for a shape or route the kernels do not take).
extern "C" int bn_stats_launch(const void* x, void* out, int B, int C, int T,
                               int bf16, int route, void* stream, int* taken) {
  if (!shape_ok(B, C, T)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const cudaError_t e =
      bf16 ? launch_stats(static_cast<const __nv_bfloat16*>(x), o, B, C, T,
                          route, taken, s)
           : launch_stats(static_cast<const float*>(x), o, B, C, T, route,
                          taken, s);
  return static_cast<int>(e);
}

// BatchNorm backward: g, x and dx (B, C, T) contiguous, one type (f32 or
// bf16 as above); scale, mean and invstd (C,) f32; gmean and gvar (C,) f32
// or null; out (2, C) f32 = [Σg, Σg·x̂]; dx may be null (the sums only).
// Same launch contract as bn_stats_launch.
extern "C" int bn_bwd_launch(const void* g, const void* x, const void* scale,
                             const void* mean, const void* invstd,
                             const void* gmean, const void* gvar, void* dx,
                             void* out, int B, int C, int T, int bf16,
                             void* stream) {
  if (!shape_ok(B, C, T)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p = {static_cast<const float*>(scale),
                     static_cast<const float*>(mean),
                     static_cast<const float*>(invstd),
                     static_cast<const float*>(gmean),
                     static_cast<const float*>(gvar),
                     static_cast<float*>(out),
                     B,
                     C,
                     T,
                     static_cast<float>(B * T)};
  const cudaError_t e = bf16 ? bwd<__nv_bfloat16>(g, x, dx, p, s)
                             : bwd<float>(g, x, dx, p, s);
  return static_cast<int>(e);
}

// g and x (B, C, T) contiguous, one type (f32 or bf16 as above); mean and
// invstd (C,) f32; out (2, C) f32 = [Σg, Σg·x̂].  Same launch contract as
// bn_stats_launch.
extern "C" int bn_bwd_stats_launch(const void* g, const void* x,
                                   const void* mean, const void* invstd,
                                   void* out, int B, int C, int T, int bf16,
                                   void* stream) {
  return bn_bwd_launch(g, x, nullptr, mean, invstd, nullptr, nullptr, nullptr,
                       out, B, C, T, bf16, stream);
}

// dx of synced BatchNorm from given sums: g, x and dx (B, C, T) contiguous,
// one type (f32 or bf16 as above); scale, mean and invstd (C,) f32; gmean
// and gvar (C,) f32 or null; sums (2, C) f32 = [Σg, Σg·x̂] over every rank;
// M the number of values each channel's statistics are over (the global
// B·T, > 0).  Same launch contract as bn_stats_launch.
extern "C" int bn_bwd_dx_launch(const void* g, const void* x,
                                const void* scale, const void* mean,
                                const void* invstd, const void* gmean,
                                const void* gvar, const void* sums, void* dx,
                                int B, int C, int T, float M, int bf16,
                                void* stream) {
  if (!shape_ok(B, C, T) || !(M > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdArgs p = {static_cast<const float*>(scale),
                     static_cast<const float*>(mean),
                     static_cast<const float*>(invstd),
                     static_cast<const float*>(gmean),
                     static_cast<const float*>(gvar),
                     nullptr,
                     B,
                     C,
                     T,
                     M};
  const float* sm = static_cast<const float*>(sums);
  const cudaError_t e = bf16 ? launch_dx<__nv_bfloat16>(g, x, dx, sm, p, s)
                             : launch_dx<float>(g, x, dx, sm, p, s);
  return static_cast<int>(e);
}
