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
// radix select over the 32-bit keys, digits of 11, 11 and 10 bits, in
// kLongPasses = 3 kernels (robust_quantiles_long_launch).  The targets of a
// row are its order statistics k and k + 1 of each quantile (2n of them).
// A full read spreads a row over CTAs (even spans of at most kLongChunk
// keys: 3 a row at 88,920 keys, 90 at 2.9 M); a CTA counts into shared
// memory, adds its nonzero bins atomically into the row's global
// histogram, and the row's last CTA (a ticket taken after a
// __threadfence) selects each target's digit and its rank among the keys
// of the longer prefix, zeroes the bins and the ticket, and writes the
// row's state.
// * Pass 0 reads the whole row with 16-byte evict-first loads, the next
//   step's in flight while a step is counted (a scalar head and tail where
//   a span is not 16-byte aligned), into 2,048-bin histograms in shared
//   memory, one a pair of warps (32 KB a CTA: 4 CTAs an SM): every key
//   carries the empty prefix, so there is no prefix test and no warp
//   intrinsic.  A thread counts through a run: keys in the run's bin
//   add to its count, and only a key in another bin spends a shared
//   atomicAdd, so a constant or quantized row, whose keys repeat, costs
//   few atomics.  Its select sizes the row's candidate list: the keys of
//   every distinct 11-bit target prefix, the chosen bins' counts.  A list
//   past the cap, T / kCandidateDiv keys (a row of one value, or of a
//   few), is not kept.
// * Pass 1 reads the row again and finds a key's slot in a 2,048-entry
//   shared table by its top digit.  A row with a list appends the keys of
//   a target's prefix to it and counts nothing: each warp gathers its keys
//   in shared memory (each lane's slots from a warp prefix sum) and moves
//   them with one atomicAdd on the list's tail a move.  A row without one
//   counts their middle digit, one histogram a distinct prefix.
// * Pass 2 finishes a row with a list in one CTA, from the list alone and
//   in shared memory: the middle digit of its keys and their select, then
//   the last digit of the keys with a target's 22-bit prefix (a table by
//   the middle digit, then the top digit compared) and the blend; no global
//   bins, no ticket.  Where the cap passes kWideListKeys (the pooled rows)
//   that CTA has kWideThreads threads.  A row without a list counts its
//   last digit over the whole row again, on all its CTAs.
// Exact for every key, NaN, inf and signed zero included: only integer
// counts.  Traffic: two reads of the row, its candidates written and read
// twice (~8 % of a Gaussian row), 3 reads at worst; the scratch, list
// included, stays within one copy of x's bytes for rows past kSharedMaxT
// (ops/kernels/quantile.py:long_scratch_words).  The bound is one read of
// the row (0.210 ms at Brennan's 704 MB); the design's traffic floor is
// about 2.2 reads.  chip_smoke.py measures ~0.75 ms a call at both Brennan
// shapes on an H100 SXM (passes 0 / 1 / 2 ~0.35 / 0.30 / 0.11 ms at 1,980
// rows of 88,920 keys): pass 0 is held by its shared atomics (a constant
// row, whose runs spend almost none, takes 0.27 ms), pass 1 by the reads
// themselves, pass 2 by the lists' finishes, one CTA a row.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

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

// ---- rows kept in global memory: radix select, 11 + 11 + 10 bits -----

constexpr int kMaxTargets = 2 * kMaxQuantiles;  // order statistics k, k + 1
constexpr int kHighBits = 11;        // pass 0's digit: key bits 31..21
constexpr int kMidBits = 11;         // the next digit: bits 20..10
constexpr int kLowBits = 10;         // the last digit: bits 9..0
constexpr int kLongPasses = 3;       // one kernel a pass
constexpr int kDigitBins = 2048;     // bins of the widest digit
constexpr int kLongThreads = 256;    // passes 0 and 1, and pass 2 on short rows
constexpr int kWideThreads = 1024;   // pass 2 where the cap passes:
constexpr int kWideListKeys = 65536;
constexpr int kLongUnroll = 4;       // 16-byte loads a thread a step
constexpr int kLongChunk = 32768;    // most keys a kLongThreads CTA reads
constexpr int kCandidateDiv = 4;     // the cap: a row's list <= T / 4 keys
constexpr int kStateWords = 32;      // a row's prefix[8], remain[8], total
constexpr int kStateRemain = kMaxTargets;
constexpr int kStateTotal = 2 * kMaxTargets;  // its list's keys, -1: none
constexpr int kHist0Copies = 4;      // pass 0: a histogram a pair of warps
constexpr int kHist0Bytes = kHist0Copies * kDigitBins * 4;  // 32 KB
constexpr unsigned kNoSlot = 0xffu;
constexpr int kWarpList = 768;       // list keys a warp gathers before a move
constexpr int kPass0MinBlocks = 4;   // CTAs an SM in pass 0
constexpr int kListMinBlocks = 4;    // CTAs an SM in passes 1 and 2

static_assert(kHighBits + kMidBits + kLowBits == 32, "digits cover a key");
static_assert((1 << kHighBits) == kDigitBins && (1 << kMidBits) == kDigitBins,
              "the widest digits fill kDigitBins");
static_assert(kDigitBins == kLongThreads * 8, "select: 8 bins a thread");
static_assert(kMaxTargets <= 8, "the slot masks are 8 bits");
static_assert(kWarpList >= 32 * 4 * kLongUnroll, "a warp's step fits its list");
static_assert((kLongThreads / 32) % kHist0Copies == 0, "warps share copies evenly");

// Pointers and sizes of a long-row call (robust_quantiles_long_launch).
struct LongArgs {
  const float* x;         // (N, T)
  float* out;             // (N, spec.n)
  long long T;
  long long cand_stride;  // keys of a row's candidate region: the cap
  int ctas;               // CTAs a row in this pass's full reads
  int n_t;                // targets: 2 a quantile
  unsigned* hist;         // N x n_t x kDigitBins, zero on entry and exit
  unsigned* ticket;       // N, zero on entry and exit
  unsigned* tail;         // N, zero on entry and exit
  int* state;             // N x kStateWords
  unsigned* cand;         // N x cand_stride
};

// A row's select, in shared memory: per warp a partial sum, per target its
// digit, its remaining rank and its bin's count, and the ticket's verdict.
struct SelectShared {
  unsigned warp[kWideThreads / 32];
  unsigned digit[kMaxTargets], rem[kMaxTargets], cnt[kMaxTargets];
  int last;
};

// The flipped key of float bits as an unsigned integer: unsigned order =
// float total order.
__device__ __forceinline__ unsigned ukey_bits(unsigned b) {
  return static_cast<unsigned>(flip(static_cast<int>(b))) ^ 0x80000000u;
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

// Numbers the targets' distinct prefixes in target order: slot[t] is the
// same in every CTA, in the select and in the next pass, and targets that
// share a prefix share its bins.  Returns the number of slots.
__device__ __forceinline__ int number_slots(const unsigned (&p)[kMaxTargets],
                                            int n_t, int (&slot)[kMaxTargets]) {
  int d = 0;
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    int s = -1;
    if (t < n_t) {
#pragma unroll
      for (int o = 0; o < t; ++o) {
        if (s < 0 && p[o] == p[t]) s = slot[o];
      }
      if (s < 0) s = d++;
    }
    slot[t] = s;
  }
  return d;
}

// The keys of [p, p + n), a step at a time: 16-byte evict-first loads from
// the first 16-byte boundary on, kLongUnroll a thread, the next step's in
// flight while a step is counted; the keys before the boundary and after
// the last whole vector (at most 3 + 3) in one more step, on warp 0's
// lanes.  Every thread of the CTA runs every step.
template <int THREADS>
struct KeyStream {
  static constexpr int kKeys = 4 * kLongUnroll;          // a thread's, a step
  static constexpr int kStep = THREADS * kLongUnroll;    // vectors, a step
  const unsigned* p;
  const uint4* vec;
  long long n_vec, head, tail, steps;
  uint4 nxt[kLongUnroll];

  __device__ __forceinline__ KeyStream(const unsigned* src, long long n)
      : p(src) {
    head = ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2;
    if (head > n) head = n;
    n_vec = (n - head) >> 2;
    tail = n - head - 4 * n_vec;
    vec = reinterpret_cast<const uint4*>(src + head);
    steps = (n_vec + kStep - 1) / kStep;
  }

  __device__ __forceinline__ void load(long long v0) {
#pragma unroll
    for (int u = 0; u < kLongUnroll; ++u) {
      const long long v = v0 + u * THREADS;
      nxt[u] = v < n_vec ? __ldcs(vec + v) : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // The first step's loads: issued before the caller sets up its shared
  // memory, so that they are in flight meanwhile.
  __device__ __forceinline__ void prime() { load(threadIdx.x); }

  // body(k, ok) for each step: k a thread's kKeys keys (raw bits), bit q of
  // ok set where k[q] is one of the range's.
  template <class Body>
  __device__ __forceinline__ void run(Body&& body) {
    const long long n_iter = steps + (head + tail > 0 ? 1 : 0);
    for (long long it = 0; it < n_iter; ++it) {
      unsigned k[kKeys];
      unsigned ok = 0;
      if (it < steps) {
        const long long v0 = it * kStep + threadIdx.x;
#pragma unroll
        for (int u = 0; u < kLongUnroll; ++u) {
          k[4 * u] = nxt[u].x;
          k[4 * u + 1] = nxt[u].y;
          k[4 * u + 2] = nxt[u].z;
          k[4 * u + 3] = nxt[u].w;
          if (v0 + u * THREADS < n_vec) ok |= 0xfu << (4 * u);
        }
        if (it + 1 < steps) load(v0 + kStep);
      } else {
#pragma unroll
        for (int q = 0; q < kKeys; ++q) k[q] = 0u;
        const int i = threadIdx.x;
        if (i < head + tail) {
          ok = 1u;
          k[0] = __ldcs(p + (i < head ? i : head + 4 * n_vec + (i - head)));
        }
      }
      body(k, ok);
    }
  }
};

// A thread's counts through a run: a key in the run's bin adds one to the
// run's count, a key in another bin flushes the count with one shared
// atomicAdd.  Runs of equal bins (a constant or quantized row, slowly
// moving samples) cost one atomic, and no key costs a warp intrinsic.
struct RunCount {
  int run = -1;
  unsigned n = 0;
  __device__ __forceinline__ void add(unsigned* bins, int b) {
    if (b != run) {
      if (n != 0) atomicAdd(&bins[run], n);
      run = b;
      n = 0;
    }
    ++n;
  }
  __device__ __forceinline__ void flush(unsigned* bins) {
    if (n != 0) atomicAdd(&bins[run], n);
    n = 0;
  }
};

// A warp's appends to its row's candidate list: the warp gathers its keys
// in shared memory (each lane's slots from a warp prefix sum of its hits)
// and moves kWarpList or fewer at a time to the list, one atomicAdd on the
// list's tail a move.  Every lane of the warp calls step() every step.
struct ListAppend {
  unsigned* buf;   // the warp's kWarpList words of shared memory
  unsigned* list;
  unsigned* tail;
  unsigned n = 0;  // gathered keys, the same in every lane

  __device__ __forceinline__ void move(int lane) {
    __syncwarp();
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(tail, n);
    base = __shfl_sync(kFull, base, 0);
    for (unsigned i = lane; i < n; i += 32) list[base + i] = buf[i];
    __syncwarp();
    n = 0;
  }

  template <int KEYS>
  __device__ __forceinline__ void step(const unsigned (&k)[KEYS], unsigned hit,
                                       int lane) {
    const unsigned mine = __popc(hit);
    unsigned incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned tot = __shfl_sync(kFull, incl, 31);
    if (tot == 0) return;
    if (n + tot > kWarpList) move(lane);
    unsigned pos = n + incl - mine;
#pragma unroll
    for (int q = 0; q < KEYS; ++q) {
      if ((hit >> q) & 1u) buf[pos++] = k[q];
    }
    n += tot;
    __syncwarp();
  }
};

// Adds this CTA's `words` shared bins (the nonzero ones) into the row's
// global bins, then takes the row's ticket.  True in the row's last CTA,
// which then sees every CTA's counts.
template <int THREADS>
__device__ __forceinline__ bool add_to_row(const unsigned* sh, unsigned* gh,
                                           int words, unsigned* ticket,
                                           int ctas, SelectShared& sel) {
  for (int i = threadIdx.x; i < words; i += THREADS) {
    const unsigned c = sh[i];
    if (c != 0) atomicAdd(&gh[i], c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    sel.last = atomicAdd(ticket, 1u) == static_cast<unsigned>(ctas - 1);
  }
  __syncthreads();
  if (!sel.last) return false;
  __threadfence();
  return true;
}

// The select over d slots of kBins bins (slot j at bins + j * kBins), in
// global memory (read through L2 and left zero: each bin has one reader) or
// in shared memory: per slot a CTA-wide prefix sum of 8 bins a thread; the
// thread whose bins hold target t's remaining rank r[t] writes its digit,
// its rank among the keys of the longer prefix and its bin's count to sel.
// Every thread of the CTA calls it.
template <int THREADS, int kBins, bool kGlobal>
__device__ __forceinline__ void select_digits(unsigned* bins, int d,
                                              const int (&slot)[kMaxTargets],
                                              const unsigned (&r)[kMaxTargets],
                                              SelectShared& sel) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = threadIdx.x * 8;
#pragma unroll 1
  for (int j = 0; j < d; ++j) {
    unsigned c[8], sum = 0;
    if (b0 < kBins) {
      uint4* h = reinterpret_cast<uint4*>(bins + j * kBins + b0);
      uint4 lo, hi;
      if (kGlobal) {
        lo = __ldcg(h);
        hi = __ldcg(h + 1);
        h[0] = h[1] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        lo = h[0];
        hi = h[1];
      }
      c[0] = lo.x, c[1] = lo.y, c[2] = lo.z, c[3] = lo.w;
      c[4] = hi.x, c[5] = hi.y, c[6] = hi.z, c[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) c[e] = 0u;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += c[e];
    unsigned incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) sel.warp[warp] = incl;
    __syncthreads();
    unsigned excl = incl - sum;
    for (int w = 0; w < warp; ++w) excl += sel.warp[w];
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (slot[t] != j || r[t] < excl || r[t] - excl >= sum) continue;
      unsigned x = r[t] - excl;
      int digit = -1;
      unsigned cnt = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (digit < 0) {
          if (x < c[e]) {
            digit = e;
            cnt = c[e];
          } else {
            x -= c[e];
          }
        }
      }
      sel.digit[t] = static_cast<unsigned>(b0 + digit);
      sel.rem[t] = x;
      sel.cnt[t] = cnt;
    }
    __syncthreads();  // sel.warp is rewritten by the next slot
  }
}

// CTA `part` of a row's `ctas` in a full read: an even span, a multiple of
// 4 keys (16-byte loads stay aligned where the row is).
__device__ __forceinline__ void row_span(long long len, int ctas, long long part,
                                         long long& begin, long long& n) {
  const long long span = (((len + ctas - 1) / ctas) + 3) & ~3LL;
  begin = part * span < len ? part * span : len;
  const long long end = begin + span < len ? begin + span : len;
  n = end - begin;
}

// Pass 0: the top 11 bits of every key of the row, into one histogram a
// pair of warps (every key carries the empty prefix: no prefix test and no
// warp intrinsic), the copies summed into the row's global histogram.  The
// row's last CTA selects each target's top digit and sizes the row's
// candidate list: the keys of each distinct 11-bit prefix, the chosen bins'
// counts, kept only within the cap.
__global__ void __launch_bounds__(kLongThreads, kPass0MinBlocks)
    quantile_long_pass0_kernel(LongArgs a, QuantileSpec spec) {
  constexpr int kTop = 32 - kHighBits;
  constexpr int kWarps = kLongThreads / 32;
  constexpr int kCopies = kHist0Copies;
  extern __shared__ uint4 sh4[];
  unsigned* sh = reinterpret_cast<unsigned*>(sh4);
  __shared__ SelectShared sel;
  const long long row = blockIdx.x / a.ctas;
  const long long part = blockIdx.x % a.ctas;
  long long begin, n;
  row_span(a.T, a.ctas, part, begin, n);
  KeyStream<kLongThreads> ks(
      reinterpret_cast<const unsigned*>(a.x) + row * a.T + begin, n);
  ks.prime();
  for (int i = threadIdx.x; i < kCopies * kDigitBins / 4; i += kLongThreads) {
    sh4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  unsigned* mine = sh + (threadIdx.x >> 5) / (kWarps / kCopies) * kDigitBins;
  RunCount rc;
  ks.run([&](unsigned (&k)[4 * kLongUnroll], unsigned ok) {
#pragma unroll
    for (int q = 0; q < 4 * kLongUnroll; ++q) {
      if ((ok >> q) & 1u) rc.add(mine, static_cast<int>(ukey_bits(k[q]) >> kTop));
    }
  });
  rc.flush(mine);
  __syncthreads();
  // the copies summed, 4 bins at a time, into the first
  for (int b4 = threadIdx.x; b4 < kDigitBins / 4; b4 += kLongThreads) {
    uint4 c = sh4[b4];
#pragma unroll
    for (int w = 1; w < kCopies; ++w) {
      const uint4 o = sh4[w * (kDigitBins / 4) + b4];
      c.x += o.x, c.y += o.y, c.z += o.z, c.w += o.w;
    }
    sh4[b4] = c;
  }
  __syncthreads();
  unsigned* gh = a.hist + row * a.n_t * kDigitBins;
  if (!add_to_row<kLongThreads>(sh, gh, kDigitBins, &a.ticket[row], a.ctas,
                                sel)) {
    return;
  }
  unsigned r[kMaxTargets];
  unsigned p[kMaxTargets];
  int slot[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    r[t] = t < a.n_t ? static_cast<unsigned>(target_rank(spec, t)) : 0u;
    p[t] = 0u;
  }
  number_slots(p, a.n_t, slot);  // one slot: every key's empty prefix
  select_digits<kLongThreads, kDigitBins, true>(gh, 1, slot, r, sel);
  if (threadIdx.x != 0) return;
  a.ticket[row] = 0u;
  int* sw = a.state + row * kStateWords;
  long long n_list = 0;
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    if (t >= a.n_t) continue;
    p[t] = sel.digit[t] << kTop;
    sw[t] = static_cast<int>(p[t]);
    sw[kStateRemain + t] = static_cast<int>(sel.rem[t]);
    bool first = true;
#pragma unroll
    for (int o = 0; o < t; ++o) {
      if (p[o] == p[t]) first = false;
    }
    if (first) n_list += sel.cnt[t];
  }
  sw[kStateTotal] = n_list <= a.cand_stride ? static_cast<int>(n_list) : -1;
}

// Pass 1: the row again.  A row whose list fits the cap appends each key
// of a target's 11-bit prefix to its list (found in a 2,048-entry shared
// table by the key's top digit) and counts nothing.  A row without a list
// counts the next 11 bits of those keys, one histogram a distinct prefix,
// into the row's global histogram, and its last CTA selects each target's
// next digit.
__global__ void __launch_bounds__(kLongThreads, kListMinBlocks)
    quantile_long_pass1_kernel(LongArgs a, QuantileSpec spec) {
  constexpr int kTop = 32 - kHighBits;
  constexpr int kKeys = 4 * kLongUnroll;
  extern __shared__ uint4 sh4[];
  unsigned* sh = reinterpret_cast<unsigned*>(sh4);
  __shared__ unsigned char s_slot[kDigitBins];  // top digit -> slot
  __shared__ SelectShared sel;
  const long long row = blockIdx.x / a.ctas;
  const long long part = blockIdx.x % a.ctas;
  const int lane = threadIdx.x & 31;
  long long begin, n;
  row_span(a.T, a.ctas, part, begin, n);
  KeyStream<kLongThreads> ks(
      reinterpret_cast<const unsigned*>(a.x) + row * a.T + begin, n);
  ks.prime();
  const int* st = a.state + row * kStateWords;
  const bool listed = st[kStateTotal] >= 0;
  unsigned p[kMaxTargets];
  int slot[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    p[t] = t < a.n_t ? static_cast<unsigned>(st[t]) : 0u;
  }
  const int d = number_slots(p, a.n_t, slot);
  if (!listed) {
    for (int i = threadIdx.x; i < d * kDigitBins / 4; i += kLongThreads) {
      sh4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  for (int i = threadIdx.x; i < kDigitBins; i += kLongThreads) {
    s_slot[i] = kNoSlot;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (slot[t] >= 0) s_slot[p[t] >> kTop] = static_cast<unsigned char>(slot[t]);
    }
  }
  __syncthreads();
  if (listed) {
    ListAppend app{sh + (threadIdx.x >> 5) * kWarpList,
                   a.cand + row * a.cand_stride, &a.tail[row]};
    ks.run([&](unsigned (&k)[kKeys], unsigned ok) {
      unsigned hit = 0;
#pragma unroll
      for (int q = 0; q < kKeys; ++q) {
        k[q] = ukey_bits(k[q]);
        if (((ok >> q) & 1u) && s_slot[k[q] >> kTop] != kNoSlot) hit |= 1u << q;
      }
      app.step(k, hit, lane);
    });
    if (app.n != 0) app.move(lane);
    return;
  }
  RunCount rc;
  ks.run([&](unsigned (&k)[kKeys], unsigned ok) {
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      if (!((ok >> q) & 1u)) continue;
      const unsigned u = ukey_bits(k[q]);
      const unsigned s = s_slot[u >> kTop];
      if (s != kNoSlot) {
        rc.add(sh, static_cast<int>(s) * kDigitBins +
                       static_cast<int>((u >> kLowBits) & (kDigitBins - 1)));
      }
    }
  });
  rc.flush(sh);
  __syncthreads();
  unsigned* gh = a.hist + row * a.n_t * kDigitBins;
  if (!add_to_row<kLongThreads>(sh, gh, d * kDigitBins, &a.ticket[row],
                                a.ctas, sel)) {
    return;
  }
  unsigned r[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    r[t] = t < a.n_t ? static_cast<unsigned>(st[kStateRemain + t]) : 0u;
  }
  select_digits<kLongThreads, kDigitBins, true>(gh, d, slot, r, sel);
  if (threadIdx.x != 0) return;
  a.ticket[row] = 0u;
  int* sw = a.state + row * kStateWords;
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    if (t < a.n_t) {
      sw[t] = static_cast<int>(p[t] | (sel.digit[t] << kLowBits));
      sw[kStateRemain + t] = static_cast<int>(sel.rem[t]);
    }
  }
}

// Pass 2: the last digit, and the blend.  A row with a list is finished by
// its first CTA alone from the list, in shared memory: the middle 11 bits of
// the list's keys, one histogram a distinct 11-bit prefix, and their select;
// then the last 10 bits of the keys with a target's 22-bit prefix (a table
// by the middle digit, then the top digit compared).  A row without a list
// counts the last 10 bits over the whole row again, on all its CTAs, into
// the row's global histogram, and its last CTA selects.
template <int THREADS>
__global__ void __launch_bounds__(THREADS,
                                  THREADS == kLongThreads ? kListMinBlocks : 1)
    quantile_long_pass2_kernel(LongArgs a, QuantileSpec spec) {
  constexpr int kTop = 32 - kHighBits;
  constexpr int kLowBins = 1 << kLowBits;
  constexpr int kKeys = KeyStream<THREADS>::kKeys;
  extern __shared__ uint4 sh4[];
  unsigned* sh = reinterpret_cast<unsigned*>(sh4);
  // a key's top digit -> its prefix's slot, then a key's middle digit -> the
  // bits of the slots whose 22-bit prefix ends in it, and s_top each slot's
  // top digit
  __shared__ unsigned char s_slot[kDigitBins];
  __shared__ unsigned s_top[kMaxTargets];
  __shared__ SelectShared sel;
  const long long row = blockIdx.x / a.ctas;
  const long long part = blockIdx.x % a.ctas;
  const int* st = a.state + row * kStateWords;
  const int total = st[kStateTotal];
  const bool listed = total >= 0;
  if (listed && part != 0) return;  // the whole CTA
  const unsigned* src;
  long long n;
  if (listed) {
    src = a.cand + row * a.cand_stride;
    n = total;
  } else {
    long long begin;
    row_span(a.T, a.ctas, part, begin, n);
    src = reinterpret_cast<const unsigned*>(a.x) + row * a.T + begin;
  }
  KeyStream<THREADS> ks(src, n);
  ks.prime();
  unsigned p[kMaxTargets], r[kMaxTargets];
  int slot[kMaxTargets];
#pragma unroll
  for (int t = 0; t < kMaxTargets; ++t) {
    p[t] = t < a.n_t ? static_cast<unsigned>(st[t]) : 0u;
    r[t] = t < a.n_t ? static_cast<unsigned>(st[kStateRemain + t]) : 0u;
  }
  int d = number_slots(p, a.n_t, slot);
  if (listed) {
    for (int i = threadIdx.x; i < d * kDigitBins / 4; i += THREADS) {
      sh4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < kDigitBins; i += THREADS) s_slot[i] = kNoSlot;
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int t = 0; t < kMaxTargets; ++t) {
        if (slot[t] >= 0) s_slot[p[t] >> kTop] = static_cast<unsigned char>(slot[t]);
      }
    }
    __syncthreads();
    RunCount rc;
    ks.run([&](unsigned (&k)[kKeys], unsigned ok) {
#pragma unroll
      for (int q = 0; q < kKeys; ++q) {
        if (!((ok >> q) & 1u)) continue;
        // every listed key carries one of the slots' prefixes
        rc.add(sh, static_cast<int>(s_slot[k[q] >> kTop]) * kDigitBins +
                       static_cast<int>((k[q] >> kLowBits) & (kDigitBins - 1)));
      }
    });
    rc.flush(sh);
    __syncthreads();
    select_digits<THREADS, kDigitBins, false>(sh, d, slot, r, sel);
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (t < a.n_t) {
        p[t] |= sel.digit[t] << kLowBits;
        r[t] = sel.rem[t];
      }
    }
    d = number_slots(p, a.n_t, slot);
    __syncthreads();  // every thread has read sel and s_slot
    ks = KeyStream<THREADS>(src, n);
    ks.prime();
  }
  for (int i = threadIdx.x; i < d * kLowBins / 4; i += THREADS) {
    sh4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = threadIdx.x; i < kDigitBins; i += THREADS) s_slot[i] = 0u;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int t = 0; t < kMaxTargets; ++t) {
      if (slot[t] < 0) continue;
      s_slot[(p[t] >> kLowBits) & (kDigitBins - 1)] |= 1u << slot[t];
      s_top[slot[t]] = p[t] >> kTop;
    }
  }
  __syncthreads();
  RunCount rc;
  ks.run([&](unsigned (&k)[kKeys], unsigned ok) {
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      if (!((ok >> q) & 1u)) continue;
      const unsigned u = listed ? k[q] : ukey_bits(k[q]);
      unsigned m = s_slot[(u >> kLowBits) & (kDigitBins - 1)];
      while (m != 0) {
        const int s = __ffs(m) - 1;
        if ((u >> kTop) == s_top[s]) {
          rc.add(sh, s * kLowBins + static_cast<int>(u & (kLowBins - 1)));
          break;
        }
        m &= m - 1;
      }
    }
  });
  rc.flush(sh);
  __syncthreads();
  if (listed) {
    select_digits<THREADS, kLowBins, false>(sh, d, slot, r, sel);
  } else {
    unsigned* gh = a.hist + row * a.n_t * kDigitBins;
    if (!add_to_row<THREADS>(sh, gh, d * kLowBins, &a.ticket[row], a.ctas,
                             sel)) {
      return;
    }
    select_digits<THREADS, kLowBins, true>(gh, d, slot, r, sel);
  }
  if (threadIdx.x != 0) return;
  if (listed) {
    a.tail[row] = 0u;
  } else {
    a.ticket[row] = 0u;
  }
#pragma unroll
  for (int q = 0; q < kMaxQuantiles; ++q) {
    if (q >= spec.n) break;
    const float v_lo = ukey_value(p[2 * q] | sel.digit[2 * q]);
    float v = v_lo;
    if (spec.interp[q]) {
      const float v_hi = ukey_value(p[2 * q + 1] | sel.digit[2 * q + 1]);
      v = __fmaf_rn(v_lo, spec.w_lo[q], __fmul_rn(v_hi, spec.w_hi[q]));
    }
    a.out[row * spec.n + q] = v;
  }
}

// Sets the kernel's dynamic shared memory and launches it on `grid` CTAs.
template <class Kernel>
cudaError_t launch_long(Kernel kernel, const LongArgs& a,
                        const QuantileSpec& spec, int grid, int threads,
                        size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(a, spec);
  return cudaGetLastError();
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
// caller on x's device (ops/kernels/quantile.py:long_scratch_words):
// `zeroed`, N x (2 spec->n x kDigitBins + 2) uint32 (the histograms, the
// tickets and the lists' tails), ZERO on entry and zero again on return;
// `work`, N x (kStateWords + long_candidate_stride(T)) int32 (the rows'
// state and candidate lists), anything on entry.  Launches the kLongPasses
// passes on `stream` and returns the first launch error
// (cudaErrorInvalidValue for a spec or size the kernel does not take).
static long long long_candidate_stride(long long T) {
  return (T / kCandidateDiv) & ~3LL;
}

extern "C" int robust_quantiles_long_launch(const void* x, void* out, int N,
                                            long long T,
                                            const QuantileSpec* spec,
                                            void* zeroed, void* work,
                                            void* stream) {
  if (spec->n < 1 || spec->n > kMaxQuantiles || T < 1 || T > INT_MAX ||
      N < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  LongArgs a;
  a.cand_stride = long_candidate_stride(T);
  const bool wide = a.cand_stride > kWideListKeys;
  const int threads2 = wide ? kWideThreads : kLongThreads;
  const long long ctas = (T + kLongChunk - 1) / kLongChunk;
  const long long chunk2 = (long long)kLongChunk * (threads2 / kLongThreads);
  const long long ctas2 = (T + chunk2 - 1) / chunk2;
  if (ctas * N > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.T = T;
  a.n_t = 2 * spec->n;
  a.hist = static_cast<unsigned*>(zeroed);
  a.ticket = a.hist + (int64_t)N * a.n_t * kDigitBins;
  a.tail = a.ticket + N;
  a.state = static_cast<int*>(work);
  a.cand = reinterpret_cast<unsigned*>(a.state) + (int64_t)N * kStateWords;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // shared memory: pass 0 a histogram a warp; pass 1 a histogram a slot or
  // the warps' list buffers; pass 2 a histogram a slot
  const size_t slots = static_cast<size_t>(a.n_t) * kDigitBins * 4;
  const size_t lists = (size_t)(kLongThreads / 32) * kWarpList * 4;
  a.ctas = static_cast<int>(ctas);
  cudaError_t e = launch_long(quantile_long_pass0_kernel, a, *spec,
                              a.ctas * N, kLongThreads, kHist0Bytes, s);
  if (e == cudaSuccess) {
    e = launch_long(quantile_long_pass1_kernel, a, *spec, a.ctas * N,
                    kLongThreads, slots > lists ? slots : lists, s);
  }
  if (e == cudaSuccess) {
    a.ctas = static_cast<int>(ctas2);
    e = wide ? launch_long(quantile_long_pass2_kernel<kWideThreads>, a, *spec,
                           a.ctas * N, kWideThreads, slots, s)
             : launch_long(quantile_long_pass2_kernel<kLongThreads>, a, *spec,
                           a.ctas * N, kLongThreads, slots, s);
  }
  return static_cast<int>(e);
}
