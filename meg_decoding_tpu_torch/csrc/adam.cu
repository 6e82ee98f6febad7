// Adam's update of a whole parameter list in one launch, for Hopper
// (sm_90a): train/optim.py's optimizer, which is optax.adam's arithmetic
// with a step that ok = false leaves undone.  For every element of every
// tensor of the list, with g = 0 where a tensor has no gradient:
//
//   mu' = (1−b1)·g + b1·mu
//   nu' = (1−b2)·(g·g) + b2·nu
//   u   = (mu'/c1) / (√(nu'/c2) + eps)
//   p'  = p + u·neg_lr
//
// then p, mu, nu ← p', mu', nu' where *ok, and nothing stored where not.
// neg_lr = −lr(count), c1 = 1 − b1^(count+1) and c2 = 1 − b2^(count+1) are
// 0-dim f32 tensors on the card and ok a 0-dim bool, read through their
// pointers, so a captured graph replays the update without a host read.
// The constants (1−b1), b1, (1−b2), b2 and eps come with the launch, as
// the f32 values of the plain chain's Python floats (ops/kernels/adam.py
// owns them), and each operation is
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA
// contraction), in the chain's order, so p, mu and nu are bit-identical to
// the chain's eager kernels on the card.
//
// Replaces no TPU kernel.  The JAX package runs optax.adam, which XLA fuses
// into a few loops over the parameters; eager PyTorch ran the chain as ~19
// kernels a parameter, 1,413 graph nodes a step for the brain encoder's
// list, each of which reads and writes a whole small tensor: bound by launch
// latency, ~2.2 ms a step on an H100.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  An element reads p, g, mu and
// nu and writes p, mu and nu: 28 bytes.  The speech encoder's list holds
// 9.57 M elements (268 MB, 80 µs), GOD's 7.34 M (206 MB, 61 µs).
//
// Design against that bound: each tensor is cut into chunks of kChunk
// elements and a CTA takes one chunk; the CTA finds its tensor by a binary
// search of the chunks' prefix sums (every thread alike, so the reads of
// the table are uniform).  The table (the four pointers, the numel and the
// first chunk of each tensor) is a __grid_constant__ kernel parameter,
// passed by value: a captured graph keeps it, and no copy to the card is
// needed.  4 KB of parameters hold kMaxTensors tensors; a longer list
// takes one launch per slice of kMaxTensors (ops/kernels/adam.py plans the
// slices).  A thread moves one 16-byte packet (4 f32) of each stream: a
// chunk is a packet a thread, so the grid (~9,400 CTAs for the speech
// list) keeps the card's loads in flight; a remainder of fewer than 4
// values, a base off 16-byte alignment and the 0-dim temperature go one
// value a thread.  Each element is read once and written once.  Where
// !*ok the CTAs return before reading.  On an NVIDIA H100 80GB HBM3 at
// 700 W the speech list took 0.0941 ms with one packet a thread and
// 0.0953 with four loaded before computing (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // f32 values in a 16-byte packet
constexpr int64_t kChunk = int64_t{kThreads} * kVec;  // 1,024 elements
constexpr int kMaxTensors = 88;  // 44 bytes a tensor: the table fits 4 KB

// one slice of the list; start[i] is tensor i's first chunk, start[n] the
// slice's chunks (the grid)
struct AdamTable {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];  // nullptr: no gradient (zeros)
  float* mu[kMaxTensors];
  float* nu[kMaxTensors];
  int64_t numel[kMaxTensors];
  int32_t start[kMaxTensors + 1];
  int32_t n;
};

// the chain's constants, rounded to f32 by the caller
struct Consts {
  float one_minus_b1, b1, one_minus_b2, b2, eps;
};

static_assert(sizeof(AdamTable) + sizeof(Consts) + 4 * sizeof(void*) <= 4096,
              "the table, the constants and the four scalar pointers exceed "
              "4 KB of kernel parameters");

struct Scalars {
  float neg_lr, c1, c2;
  Consts k;
};

// one element, each operation rounded as the chain's kernels round it
__device__ __forceinline__ void adam1(float& p, float g, float& mu, float& nu,
                                      const Scalars& s) {
  const float m = __fadd_rn(__fmul_rn(s.k.one_minus_b1, g),
                            __fmul_rn(s.k.b1, mu));
  const float v = __fadd_rn(__fmul_rn(s.k.one_minus_b2, __fmul_rn(g, g)),
                            __fmul_rn(s.k.b2, nu));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), s.k.eps);
  const float u = __fdiv_rn(__fdiv_rn(m, s.c1), den);
  p = __fadd_rn(p, __fmul_rn(u, s.neg_lr));
  mu = m;
  nu = v;
}

__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& mu,
                                      float4& nu, const Scalars& s) {
  adam1(p.x, g.x, mu.x, nu.x, s);
  adam1(p.y, g.y, mu.y, nu.y, s);
  adam1(p.z, g.z, mu.z, nu.z, s);
  adam1(p.w, g.w, mu.w, nu.w, s);
}

// p, mu and nu are written back by the thread that reads them: plain
// loads; g is only read: the read-only path
__device__ __forceinline__ float4 load4(const float* a, int64_t i) {
  return reinterpret_cast<const float4*>(a)[i];
}

__device__ __forceinline__ float4 ldg4(const float* a, int64_t i) {
  return __ldg(reinterpret_cast<const float4*>(a) + i);
}

__device__ __forceinline__ void store4(float* a, int64_t i, float4 v) {
  reinterpret_cast<float4*>(a)[i] = v;
}

__global__ void __launch_bounds__(kThreads) adam_multi_tensor_kernel(
    const __grid_constant__ AdamTable t, const Consts k,
    const float* __restrict__ neg_lr,
    const float* __restrict__ c1, const float* __restrict__ c2,
    const bool* __restrict__ ok) {
  if (!*ok) return;
  const int b = blockIdx.x;
  // the last tensor whose first chunk is at or before b (an empty tensor
  // shares its start with the next, which is found instead)
  int lo = 0, hi = t.n;  // t.start[lo] <= b < t.start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.start[mid] <= b) lo = mid; else hi = mid;
  }
  const int64_t first = int64_t{b - t.start[lo]} * kChunk;
  const int64_t rest = t.numel[lo] - first;
  const int64_t len = rest < kChunk ? rest : kChunk;
  float* __restrict__ p = t.p[lo] + first;
  float* __restrict__ mu = t.mu[lo] + first;
  float* __restrict__ nu = t.nu[lo] + first;
  const float* __restrict__ g = t.g[lo] == nullptr ? nullptr
                                                   : t.g[lo] + first;
  const Scalars s{*neg_lr, *c1, *c2, k};
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(mu) |
                          reinterpret_cast<uintptr_t>(nu) |
                          reinterpret_cast<uintptr_t>(g);
  const bool aligned = (bases & 15u) == 0;
  const int tid = threadIdx.x;
  const int64_t nvec = aligned ? len / kVec : 0;
  if (tid < nvec) {
    float4 vp = load4(p, tid), vm = load4(mu, tid), vv = load4(nu, tid);
    const float4 vg = g == nullptr ? make_float4(0.f, 0.f, 0.f, 0.f)
                                   : ldg4(g, tid);
    adam4(vp, vg, vm, vv, s);
    store4(p, tid, vp);
    store4(mu, tid, vm);
    store4(nu, tid, vv);
  }
  for (int64_t j = nvec * kVec + tid; j < len; j += kThreads) {
    float vp = p[j], vm = mu[j], vv = nu[j];
    adam1(vp, g == nullptr ? 0.f : __ldg(g + j), vm, vv, s);
    p[j] = vp;
    mu[j] = vm;
    nu[j] = vv;
  }
}

}  // namespace

// One slice of n tensors (1 <= n <= kMaxTensors): p, g, mu and nu are n
// device pointers each (g[i] may be null: no gradient), numel their sizes,
// start the n + 1 prefix sums of their chunks (start[0] = 0, start[i + 1] −
// start[i] = ⌈numel[i] / chunk⌉), chunk the planner's chunk size, which must
// be this source's kChunk.  one_minus_b1, b1, one_minus_b2, b2 and eps are
// the chain's constants in f32.  neg_lr, c1, c2 (f32) and ok (bool) point to
// one value each on the device.  Launches on `stream` (nothing where the slice
// has no element) and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a table the kernel does not take.
extern "C" int adam_multi_tensor_launch(int n, void* const* p,
                                        const void* const* g, void* const* mu,
                                        void* const* nu, const int64_t* numel,
                                        const int32_t* start, int64_t chunk,
                                        float one_minus_b1, float b1,
                                        float one_minus_b2, float b2,
                                        float eps, const void* neg_lr,
                                        const void* c1,
                                        const void* c2, const void* ok,
                                        void* stream) {
  if (n < 1 || n > kMaxTensors || chunk != kChunk || start[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (neg_lr == nullptr || c1 == nullptr || c2 == nullptr || ok == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamTable t;
  t.n = n;
  t.start[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0 || int64_t{start[i + 1]} - start[i] !=
                            (numel[i] + kChunk - 1) / kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
    if (numel[i] > 0 && (p[i] == nullptr || mu[i] == nullptr ||
                         nu[i] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = static_cast<const float*>(g[i]);
    t.mu[i] = static_cast<float*>(mu[i]);
    t.nu[i] = static_cast<float*>(nu[i]);
    t.numel[i] = numel[i];
    t.start[i + 1] = start[i + 1];
  }
  if (t.start[n] == 0) return 0;
  adam_multi_tensor_kernel<<<t.start[n], kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, Consts{one_minus_b1, b1, one_minus_b2, b2, eps},
      static_cast<const float*>(neg_lr), static_cast<const float*>(c1),
      static_cast<const float*>(c2), static_cast<const bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
