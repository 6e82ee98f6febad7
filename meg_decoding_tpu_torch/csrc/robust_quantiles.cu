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
// * order statistic k = floor(q (T-1) / 100) is the k-th smallest key,
//   exactly;
// * the interpolation partner is order statistic k + 1 (the same key when
//   it is duplicated, else the smallest strictly greater key);
// * the blend v_lo * w_lo + v_hi * w_hi uses f32 weights rounded on the
//   host and is evaluated as fmaf(v_lo, w_lo, v_hi * w_hi) — the
//   contraction XLA applies to the JAX kernel's blend on the CPU — so the
//   result matches the reference bit for bit there.
//
// Bound on an H100 SXM (3.35 TB/s): one read of the input and a small
// write.  Collate of a Gwilliams serving batch, (B·C, T) = (13312, 360):
// 19.2 MB read + 0.16 MB written -> 5.8 us.
//
// Design for rows of up to kRegisterMaxT = 1024 keys (the collate's rows
// are 360): one warp per row, the row sorted in registers.  Each lane loads
// keys j·32 + lane (coalesced, all K loads in flight) into K registers, K
// the power of two >= ceil(T/32); slots past T hold INT_MAX, which sorts
// after every key, so a pad can only sit at a sorted position >= T and no
// rank (<= T - 1) reads one.  A bitonic network then sorts the 32·K keys in
// the order i = lane·K + j: stages whose partner lies in the same lane are
// compare-exchanges of two registers, the others one __shfl_xor_sync per
// register.  The network is written in its flip form (each merge starts by
// pairing i with i ^ (k - 1)), so the lower index always keeps the smaller
// key and no stage needs a direction.  The order statistics are then read
// from the lanes that hold them.  Nothing depends on the values: no
// atomics, no branch on data, and NaN, ±inf and ±0 need no special case.
//
// Reckoned floor at (13312, 360), K = 16 (512 slots): 45 stages, 15 of
// them across lanes (16 shuffles, 16 min/max pairs and their selects
// each), 30 inside a lane (8 compare-exchanges, 16 min/max, each).  Per
// warp that is ~960 integer min/max, 240 shuffles and ~400 compares,
// selects and logic instructions.  The ~1,300 integer ALU instructions of
// each of the 13,312 warps go through the SMs' integer pipes, 64 lanes per
// clock per SM: 132 SMs at ~1.755 GHz take ~37 us.  So the sort's integer
// instructions, not its 19 MB, set the floor, ~6x the byte bound;
// chip_smoke.py measures ~40 us on an H100 SXM as a run of launches.
// Trading registers for more resident warps did not change the time, as a
// pipe limit (and not latency) predicts.  Another design gets closer only
// by issuing fewer instructions per key (a radix select, whose atomics
// collide on rows full of duplicates).
//
// Rows of up to kSharedMaxT = 58,112 keys (227 KB of opt-in shared memory)
// keep the shared-memory bisection: the row's keys in shared memory, per
// quantile 32 bisection passes over the key space (the smallest key m with
// count(keys <= m) >= k + 1) and one pass for the partner, each pass a
// strided sweep plus a __reduce_add_sync.
//
// Longer rows (a whole Brennan recording: ~89,000 keys a subject's channel,
// ~2.9 M with the subjects pooled) stay in global memory and take an exact
// radix select over the 32-bit keys, 8 bits a pass, 4 passes
// (robust_quantiles_long_launch).  The targets of a row are its order
// statistics k and k + 1 of each quantile (2n of them).  Each pass:
// * quantile_long_histogram_kernel spreads every row over CTAs of
//   kLongChunk keys (6 CTAs a row at 89,000 keys, 179 at 2.9 M: all 132
//   SMs busy at N = 60).  A CTA counts, in shared memory, the next 8-bit
//   digit of each key whose higher digits equal a target's prefix (one
//   histogram of 256 bins for each distinct prefix: targets that share one
//   share its bins), then adds its nonzero bins atomically into the row's
//   global histogram.  Equal digits within a warp are added once, by one
//   lane, with their count (__match_any_sync), so a row full of duplicates
//   does not serialise the shared-memory atomics.
// * quantile_long_select_kernel, one warp a row, scans each target's 256
//   bins (8 a lane, a warp-wide prefix sum), fixes the target's next digit
//   and its rank among the keys of the longer prefix, and zeroes the bins
//   it read for the next pass; after the last pass the prefixes are the
//   order statistics' keys and it writes the blend.
// Exact for every key, NaN, inf and signed zero included: only integer
// counts.  Bound: one read of the row per pass (4 reads in all).

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
constexpr int kRegisterMaxT = 1024;  // 32 keys per lane
constexpr int kSharedMaxT = 58112;  // a row's keys in 227 KB of shared memory
constexpr int kSortWarps = 8;        // rows per CTA on the register path

__device__ __forceinline__ int flip(int b) { return b < 0 ? b ^ INT_MAX : b; }

__device__ __forceinline__ float unflip(int k) {
  return __int_as_float(k < 0 ? k ^ INT_MAX : k);
}

// a <- min(a, b), b <- max(a, b)
__device__ __forceinline__ void cas(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

// One stage of the network whose partner differs in lane bits only:
// partner key v[j] of lane ^ m; the lower lane keeps the minimum.
template <int K>
__device__ __forceinline__ void cross_lane(int (&v)[K], int m, bool lower) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int o = __shfl_xor_sync(kFull, v[j], m);
    v[j] = lower ? min(v[j], o) : max(v[j], o);
  }
}

// Sorts the warp's 32·K keys ascending in the order i = lane·K + j.
template <int K, int LOG_K>
__device__ __forceinline__ void warp_bitonic_sort(int (&v)[K], int lane) {
#pragma unroll
  for (int lk = 1; lk <= LOG_K + 5; ++lk) {  // merges of blocks of k = 2^lk
    const int k = 1 << lk;
    if (k <= K) {  // flip stage inside the lane: j with j ^ (k - 1)
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((j ^ (k - 1)) > j) cas(v[j], v[j ^ (k - 1)]);
      }
    } else {  // across lanes: (lane, j) with (lane ^ (k/K - 1), K - 1 - j)
      int o[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        o[j] = __shfl_xor_sync(kFull, v[K - 1 - j], k / K - 1);
      }
      const bool lower = (lane & (k / (2 * K))) == 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[j] = lower ? min(v[j], o[j]) : max(v[j], o[j]);
      }
    }
#pragma unroll
    for (int ld = lk - 2; ld >= 0; --ld) {  // half-cleaners: i with i ^ d
      const int d = 1 << ld;
      if (d < K) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if ((j & d) == 0) cas(v[j], v[j | d]);
        }
      } else {
        cross_lane<K>(v, d / K, (lane & (d / K)) == 0);
      }
    }
  }
}

// The key at sorted position r (the same r in every lane).
template <int K>
__device__ __forceinline__ int key_at(const int (&v)[K], int r) {
  const int slot = r & (K - 1);
  int k = v[0];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (j == slot) k = v[j];
  }
  return __shfl_sync(kFull, k, r / K);
}

template <int K, int LOG_K>
__global__ void __launch_bounds__(kSortWarps * 32)
    robust_quantiles_sort_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int N, int T,
                                 QuantileSpec spec) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kSortWarps + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp leaves together
  const float* xr = x + (int64_t)row * T;
  int v[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int t = j * 32 + lane;
    v[j] = t < T ? flip(__float_as_int(xr[t])) : INT_MAX;
  }
  warp_bitonic_sort<K, LOG_K>(v, lane);
#pragma unroll
  for (int q = 0; q < kMaxQuantiles; ++q) {
    if (q >= spec.n) break;
    const float v_lo = unflip(key_at<K>(v, spec.rank[q]));
    float r = v_lo;
    if (spec.interp[q]) {
      const float v_hi = unflip(key_at<K>(v, spec.rank[q] + 1));
      r = __fmaf_rn(v_lo, spec.w_lo[q], __fmul_rn(v_hi, spec.w_hi[q]));
    }
    if (lane == 0) out[(int64_t)row * spec.n + q] = r;
  }
}

__global__ void robust_quantiles_bisect_kernel(const float* __restrict__ x,
                                               float* __restrict__ out, int N,
                                               int T, QuantileSpec spec) {
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

// ---- rows kept in global memory: radix select, 8 bits a pass ----------

constexpr int kMaxTargets = 2 * kMaxQuantiles;  // order statistics k, k + 1
constexpr int kBins = 256;
constexpr int kLongThreads = 256;
constexpr int kLongUnroll = 8;                           // loads in flight
constexpr int kLongStride = kLongThreads * kLongUnroll;  // keys a sweep step
constexpr int kLongChunk = 16384;                        // keys a CTA and pass
constexpr int kSelectRows = kLongThreads / 32;           // one warp a row

// The flipped key as an unsigned integer: unsigned order = float total order.
__device__ __forceinline__ unsigned ukey(float v) {
  return static_cast<unsigned>(flip(__float_as_int(v))) ^ 0x80000000u;
}

__device__ __forceinline__ float ukey_value(unsigned u) {
  return unflip(static_cast<int>(u ^ 0x80000000u));
}

// Target t of quantile t / 2: its order statistic (t even), or the
// interpolation partner (t odd; the statistic itself when the quantile does
// not interpolate, so that a rank past T - 1 is never asked for).
__device__ __forceinline__ int target_rank(const QuantileSpec& spec, int t) {
  const int q = t >> 1;
  return spec.rank[q] + ((t & 1) && spec.interp[q] ? 1 : 0);
}

__global__ void __launch_bounds__(kLongThreads)
    quantile_long_histogram_kernel(const float* __restrict__ x, int64_t T,
                          int ctas_per_row, int n_t, int pass,
                          const unsigned* __restrict__ prefix,
                          unsigned* __restrict__ hist) {
  __shared__ unsigned sh[kMaxTargets * kBins];
  const int64_t row = blockIdx.x / ctas_per_row;
  const int64_t chunk = blockIdx.x % ctas_per_row;
  // each target's prefix; a target whose prefix an earlier one shares
  // counts into that one's bins (own = false), the same in every thread
  unsigned p[kMaxTargets];
  bool own[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    p[t] = (pass > 0 && t < n_t) ? prefix[row * kMaxTargets + t] : 0u;
    own[t] = t < n_t;
#pragma unroll
    for (int o = 0; o < t; ++o) {
      if (p[o] == p[t]) own[t] = false;
    }
  }
  for (int i = threadIdx.x; i < n_t * kBins; i += kLongThreads) sh[i] = 0;
  __syncthreads();

  const int shift = 24 - 8 * pass;
  const unsigned mask = pass == 0 ? 0u : 0xffffffffu << (32 - 8 * pass);
  const int lane = threadIdx.x & 31;
  const float* xr = x + row * T;
  const int64_t start = chunk * kLongChunk;
  const int64_t end = start + kLongChunk < T ? start + kLongChunk : T;
  for (int64_t base = start; base < end; base += kLongStride) {
    unsigned u[kLongUnroll];
#pragma unroll
    for (int j = 0; j < kLongUnroll; ++j) {
      const int64_t i = base + j * kLongThreads + threadIdx.x;
      u[j] = i < end ? ukey(xr[i]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kLongUnroll; ++j) {
      const bool valid = base + j * kLongThreads + threadIdx.x < end;
      const unsigned digit = (u[j] >> shift) & (kBins - 1);
#pragma unroll
      for (int t = 0; t < kMaxTargets; ++t) {
        if (!own[t]) continue;  // uniform across the CTA
        const bool m = valid && (u[j] & mask) == p[t];
        const unsigned act = __ballot_sync(kFull, m);
        if (m) {
          const unsigned peers = __match_any_sync(act, digit);
          if (lane == __ffs(peers) - 1) {
            atomicAdd(&sh[t * kBins + digit],
                      static_cast<unsigned>(__popc(peers)));
          }
        }
      }
    }
  }
  __syncthreads();
  unsigned* hr = hist + row * n_t * kBins;
  for (int i = threadIdx.x; i < n_t * kBins; i += kLongThreads) {
    const unsigned c = sh[i];
    if (c != 0) atomicAdd(&hr[i], c);
  }
}

__global__ void __launch_bounds__(kLongThreads)
    quantile_long_select_kernel(int N, int n_t, int pass, QuantileSpec spec,
                       unsigned* __restrict__ hist,
                       unsigned* __restrict__ prefix, int* __restrict__ remain,
                       float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kSelectRows + (threadIdx.x >> 5);
  if (row >= N) return;  // the whole warp leaves together
  const int shift = 24 - 8 * pass;
  unsigned* hr = hist + row * n_t * kBins;
  unsigned p[kMaxTargets], np[kMaxTargets];
  unsigned r[kMaxTargets], nr[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    const bool live = t < n_t;
    p[t] = (pass > 0 && live) ? prefix[row * kMaxTargets + t] : 0u;
    r[t] = !live ? 0u
           : pass > 0 ? static_cast<unsigned>(remain[row * kMaxTargets + t])
                      : static_cast<unsigned>(target_rank(spec, t));
  }
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    np[t] = p[t];
    nr[t] = r[t];
    if (t >= n_t) continue;
    int s = t;  // the first target with this prefix holds its bins
#pragma unroll
    for (int o = t - 1; o >= 0; --o) {
      if (p[o] == p[t]) s = o;
    }
    const unsigned* h = hr + s * kBins + lane * 8;
    unsigned c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = h[j];
      sum += c[j];
    }
    unsigned incl = sum;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    // the lane whose bins hold rank r[t]: the first with r < incl (one
    // exists, since the prefix's keys number more than r)
    const int owner = __ffs(__ballot_sync(kFull, r[t] < incl)) - 1;
    unsigned rr = r[t] - (incl - sum);
    int digit = lane * 8 + 7;
    bool found = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!found) {
        if (rr < c[j]) {
          digit = lane * 8 + j;
          found = true;
        } else {
          rr -= c[j];
        }
      }
    }
    digit = __shfl_sync(kFull, digit, owner);
    rr = __shfl_sync(kFull, rr, owner);
    np[t] = p[t] | (static_cast<unsigned>(digit) << shift);
    nr[t] = rr;
  }
  __syncwarp();
  // this warp is the bins' only reader: leave them zero for the next pass
  for (int i = lane; i < n_t * kBins; i += 32) hr[i] = 0;
  if (lane != 0) return;
  if (pass < 3) {
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (t < n_t) {
        prefix[row * kMaxTargets + t] = np[t];
        remain[row * kMaxTargets + t] = static_cast<int>(nr[t]);
      }
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < kMaxQuantiles; ++q) {
    if (q >= spec.n) break;
    const float v_lo = ukey_value(np[2 * q]);
    float v = v_lo;
    if (spec.interp[q]) {
      const float v_hi = ukey_value(np[2 * q + 1]);
      v = __fmaf_rn(v_lo, spec.w_lo[q], __fmul_rn(v_hi, spec.w_hi[q]));
    }
    out[row * spec.n + q] = v;
  }
}

template <int K, int LOG_K>
void launch_sort(const float* x, float* out, int N, int T,
                 const QuantileSpec& spec, cudaStream_t s) {
  robust_quantiles_sort_kernel<K, LOG_K>
      <<<(N + kSortWarps - 1) / kSortWarps, kSortWarps * 32, 0, s>>>(
          x, out, N, T, spec);
}

}  // namespace

// x (N, T) f32 and out (N, spec->n) f32, contiguous on the device; `spec`
// points to host memory and is passed to the kernel by value.  Launches on
// `stream` and returns cudaGetLastError() (cudaErrorInvalidValue for a
// spec or row length the kernel does not take: longer rows than
// kSharedMaxT go to robust_quantiles_long_launch).
extern "C" int robust_quantiles_launch(const void* x, void* out, int N, int T,
                                       const QuantileSpec* spec,
                                       void* stream) {
  if (spec->n < 1 || spec->n > kMaxQuantiles || T < 1 || T > kSharedMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (T <= kRegisterMaxT) {
    const int per_lane = (T + 31) / 32;
    if (per_lane <= 1) {
      launch_sort<1, 0>(xf, of, N, T, *spec, s);
    } else if (per_lane <= 2) {
      launch_sort<2, 1>(xf, of, N, T, *spec, s);
    } else if (per_lane <= 4) {
      launch_sort<4, 2>(xf, of, N, T, *spec, s);
    } else if (per_lane <= 8) {
      launch_sort<8, 3>(xf, of, N, T, *spec, s);
    } else if (per_lane <= 16) {
      launch_sort<16, 4>(xf, of, N, T, *spec, s);
    } else {
      launch_sort<32, 5>(xf, of, N, T, *spec, s);
    }
    return static_cast<int>(cudaGetLastError());
  }
  // 8 warps (rows) per CTA while their keys fit the default 48 KB of
  // shared memory; longer rows take fewer warps, then the opt-in maximum
  const size_t row_bytes = (size_t)T * sizeof(int);
  int warps = 8;
  while (warps > 1 && warps * row_bytes > 48 * 1024) warps >>= 1;
  const size_t smem = warps * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        robust_quantiles_bisect_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (N + warps - 1) / warps;
  robust_quantiles_bisect_kernel<<<grid, warps * 32, smem, s>>>(xf, of, N, T,
                                                                *spec);
  return static_cast<int>(cudaGetLastError());
}

// Rows of any length (the path for T > kSharedMaxT): x (N, T) f32 and out
// (N, spec->n) f32, contiguous on the device.  Scratch, allocated by the
// caller on x's device: `hist`, N * 2 * spec->n * 256 uint32, ZERO on entry
// (and zero again on return: each pass clears the bins it read), and
// `state`, N * 2 * 8 int32.  Launches 4 x (histogram, select) on `stream`
// and returns the first launch error (cudaErrorInvalidValue for a spec the
// kernel does not take).
extern "C" int robust_quantiles_long_launch(const void* x, void* out, int N,
                                            long long T,
                                            const QuantileSpec* spec,
                                            void* hist, void* state,
                                            void* stream) {
  if (spec->n < 1 || spec->n > kMaxQuantiles || T < 1 || N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const long long ctas_per_row = (T + kLongChunk - 1) / kLongChunk;
  const long long grid = ctas_per_row * N;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_t = 2 * spec->n;
  unsigned* h = static_cast<unsigned*>(hist);
  unsigned* prefix = static_cast<unsigned*>(state);
  int* remain = static_cast<int*>(state) + (int64_t)N * kMaxTargets;
  for (int pass = 0; pass < 4; ++pass) {
    quantile_long_histogram_kernel<<<(int)grid, kLongThreads, 0, s>>>(
        static_cast<const float*>(x), T, (int)ctas_per_row, n_t, pass, prefix,
        h);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    quantile_long_select_kernel<<<(N + kSelectRows - 1) / kSelectRows,
                                  kLongThreads, 0, s>>>(
        N, n_t, pass, *spec, h, prefix, remain, static_cast<float*>(out));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
