// The routing of a mixture-of-experts layer and the combine of its experts'
// outputs, for Hopper (sm_90a): DeepSeek-V2's and Kimi-Linear's MoE
// (features/deepseek_v2_model.py, features/kimi_linear_model.py),
// inference only.
//
//   route:   softmax scoring (DeepSeek-V2): p = softmax(logits) in f32 over
//            the E routed experts of each token; its k largest, greedily
//            (ties to the lower expert), the weights the probabilities.
//            Sigmoid scoring (Kimi-Linear, DeepSeek-V3's noaux_tc):
//            s = sigmoid(logits) in f32; the k largest of s + bias chosen
//            greedily; the weights s of the chosen, over their sum
//            (+ 1e-20) when renormalised, times a scale.  Then the tokens
//            each expert received (counts), where the rows of each held
//            expert (first .. first + held − 1) start in the expert-sorted
//            order (offs, cumulative ends over the held experts, as
//            torch._grouped_mm takes them), and each (token, slot) pair's
//            row there (pos; −1 for a pair sent to an expert not held) with
//            the token of each row (sorted_token; 0 past the held rows).
//            Within an expert the rows keep the pairs' order (token-major,
//            slot-minor), so the permutation is the same on every run and
//            equals a stable sort by expert.
//   combine: out[t] = bf16(bf16(Σ_r w[t, r]·ys[pos[t, r]]) + shared[t]),
//            the weighted sum in f32 (each product rounded, then added in
//            slot order; a slot whose pos is −1 adds nothing), as
//            DeepSeek's moe_infer sums the slots in f32 and adds the shared
//            experts' output in bf16.
//
// Replaces no TPU kernel: the JAX package has no language model.  It is
// the part of an expert-parallel MoE layer that no library call computes
// in one pass: torch.topk + torch.sort + bincount + scatter take a dozen
// launches and a host-visible sort; here route is two launches and a
// memset (two more memsets when some experts are not held), and combine
// one.
//
// Bound on an H100 SXM (3.35 TB/s): launch latency for route (a 2,048-
// token chunk reads 0.5 MB of f32 logits at E = 64, 2 MB at 256, and
// writes ~0.2 MB), bytes for combine (the chunk reads 6 expert rows and
// one shared row a token and writes one: 2,048 · 8 · 4 KB = 67 MB, 20 µs).
//
// Design: route's first kernel gives each token one warp (E ≤ 256: up to
// 8 logits a lane), reduces the softmax's max and sum with shuffles, and
// takes the k largest in k warp-wide argmax rounds; lane 0 counts the
// winner in the per-call counts (atomics) and, for a token below
// *n_valid, in the caller's running counter.  The second kernel is one
// block a held expert: it sums the counts of the held experts below its
// own for its offset, walks every pair in order, a block of pairs at a
// time, and gives the pairs of its expert consecutive rows by a ballot and
// a scan over warps.  combine is one block a token, one 16-byte packet
// (8 bf16) a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 8;   // E ≤ 256
constexpr int kMaxTopK = 8;
constexpr int kTopkThreads = 256;   // 8 tokens a block
constexpr int kPlaceThreads = 1024;
constexpr int kCombineThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

template <bool kSigmoid>
__global__ void moe_route_topk_kernel(const float* __restrict__ logits,
                                      int T, int E, int k,
                                      const int32_t* __restrict__ n_valid,
                                      int32_t* __restrict__ ids,
                                      float* __restrict__ weights,
                                      int32_t* __restrict__ counts,
                                      int32_t* __restrict__ counter,
                                      const float* __restrict__ bias,
                                      int renormalize, float scale) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int t = blockIdx.x * (blockDim.x / kWarp) + (threadIdx.x / kWarp);
  if (t >= T) return;  // the whole warp: t is one a warp
  const float* row = logits + static_cast<int64_t>(t) * E;
  float p[kMaxPerLane];
  float sv[kMaxPerLane];  // sigmoid scoring: the scores (p: the choices)
  if (kSigmoid) {
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + j * kWarp;
      // a picked or absent expert reads −inf, below every choice
      sv[j] = e < E ? 1.f / (1.f + expf(-row[e])) : 0.f;
      p[j] = e < E ? sv[j] + bias[e] : -INFINITY;
    }
  } else {
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int e = lane + j * kWarp;
      p[j] = e < E ? row[e] : -INFINITY;
      m = fmaxf(m, p[j]);
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      if (lane + j * kWarp < E) {
        p[j] = expf(p[j] - m);
        s += p[j];
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      // a picked or absent expert reads −1, below every probability
      p[j] = lane + j * kWarp < E ? p[j] / s : -1.f;
    }
  }
  const float picked = kSigmoid ? -INFINITY : -1.f;
  const bool counted = t < *n_valid;
  float w[kMaxTopK];
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      // j rises with the expert, so a strict > keeps the lower of a tie
      if (p[j] > bv) {
        bv = p[j];
        bi = lane + j * kWarp;
      }
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oi = __shfl_xor_sync(kFull, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (bi >= E || !(kSigmoid ? bv > -INFINITY : bv >= 0.f)) {
      // a non-finite row: slot r takes expert r with a NaN weight, so
      // that the output shows it and every row stays in range
      bi = r;
      bv = __int_as_float(0x7fffffff);
    } else if (kSigmoid) {
      // the weight is the chosen expert's score, held by lane bi % 32
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j)
        if (j == bi / kWarp) mine = sv[j];
      bv = __shfl_sync(kFull, mine, bi % kWarp);
    }
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j)
      if (lane + j * kWarp == bi) p[j] = picked;
    if (lane == 0) {
      ids[static_cast<int64_t>(t) * k + r] = bi;
      w[r] = bv;
      atomicAdd(&counts[bi], 1);
      if (counted) atomicAdd(&counter[bi], 1);
    }
  }
  if (lane == 0) {
    float den = 1.f;
    if (renormalize) {
      den = w[0];
      for (int r = 1; r < k; ++r) den += w[r];
      den += 1e-20f;
    }
    for (int r = 0; r < k; ++r) {
      float x = w[r];
      if (renormalize) x = x / den;
      if (scale != 1.f) x = x * scale;
      weights[static_cast<int64_t>(t) * k + r] = x;
    }
  }
}

__global__ void moe_route_place_kernel(const int32_t* __restrict__ ids,
                                       int n_pairs, int k, int first,
                                       const int32_t* __restrict__ counts,
                                       int32_t* __restrict__ offs,
                                       int32_t* __restrict__ pos,
                                       int32_t* __restrict__ sorted_token) {
  __shared__ int warp_hits[kPlaceThreads / kWarp];
  __shared__ int first_row;
  const int e = first + blockIdx.x;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int j = first; j < e; ++j) b += counts[j];
    first_row = b;
    offs[blockIdx.x] = b + counts[e];
  }
  __syncthreads();
  int base = first_row;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int start = 0; start < n_pairs; start += blockDim.x) {
    const int i = start + threadIdx.x;
    const bool hit = i < n_pairs && ids[i] == e;
    const unsigned mask = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < warps; ++w) {
      const int c = warp_hits[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int row = base + before + __popc(mask & ((1u << lane) - 1u));
      pos[i] = row;
      sorted_token[row] = i / k;
    }
    base += total;
    __syncthreads();  // warp_hits is rewritten by the next block of pairs
  }
}

template <bool kShared>
__global__ void moe_combine_kernel(const __nv_bfloat16* __restrict__ ys,
                                   const int32_t* __restrict__ pos,
                                   const float* __restrict__ w,
                                   const __nv_bfloat16* __restrict__ shared,
                                   __nv_bfloat16* __restrict__ out, int H,
                                   int k) {
  __shared__ int rows[kMaxTopK];
  __shared__ float ws[kMaxTopK];
  const int64_t t = blockIdx.x;
  if (threadIdx.x < k) {
    rows[threadIdx.x] = pos[t * k + threadIdx.x];
    ws[threadIdx.x] = w[t * k + threadIdx.x];
  }
  __syncthreads();
  const int packets = H / 8;
  for (int c = threadIdx.x; c < packets; c += blockDim.x) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.f;
    for (int r = 0; r < k; ++r) {
      if (rows[r] < 0) continue;  // an expert not held here
      const uint4 v = reinterpret_cast<const uint4*>(
          ys + static_cast<int64_t>(rows[r]) * H)[c];
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
      const float wr = ws[r];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        acc[q] = __fadd_rn(acc[q], __fmul_rn(__bfloat162float(b[q]), wr));
    }
    uint4 o;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&o);
    if (kShared) {
      const uint4 sv = reinterpret_cast<const uint4*>(shared + t * H)[c];
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(&sv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float y = __bfloat162float(__float2bfloat16_rn(acc[q]));
        ob[q] = __float2bfloat16_rn(__fadd_rn(y, __bfloat162float(sb[q])));
      }
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) ob[q] = __float2bfloat16_rn(acc[q]);
    }
    reinterpret_cast<uint4*>(out + t * H)[c] = o;
  }
}

}  // namespace

// logits: (T, E) f32; n_valid: one int32 on the card (the tokens below it
// are counted in counter); ids: (T, k) int32 and weights: (T, k) f32 out;
// counts: (E,) int32 scratch (zeroed here); counter: (E,) int32, added to;
// offs: (held,) int32 out; pos: (T, k) int32 out; sorted_token: (T·k,)
// int32 out.  bias: (E,) f32 for sigmoid scoring, null for softmax;
// renormalize and scale as the module comment says; the held experts are
// first .. first + held − 1 (0 and E: all).  1 ≤ k ≤ 8, k ≤ E ≤ 256.
// Launches on stream without a sync; returns the CUDA error of a memset or
// of a launch (0 on success).
extern "C" int moe_route_launch(const float* logits, int T, int E, int k,
                                const int32_t* n_valid, int32_t* ids,
                                float* weights, int32_t* counts,
                                int32_t* counter, int32_t* offs, int32_t* pos,
                                int32_t* sorted_token, const float* bias,
                                int renormalize, float scale, int first,
                                int held, void* stream) {
  if (T < 0 || E < 1 || E > kWarp * kMaxPerLane || k < 1 || k > kMaxTopK ||
      k > E || first < 0 || held < 1 || first + held > E)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * E, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T == 0) {
    err = cudaMemsetAsync(offs, 0, sizeof(int32_t) * held, s);
    return static_cast<int>(err);
  }
  if (held < E) {
    // the pairs of experts not held keep pos −1; rows past the held ones
    // gather token 0
    err = cudaMemsetAsync(pos, 0xff, sizeof(int32_t) * T * k, s);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(sorted_token, 0, sizeof(int32_t) * T * k, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int per_block = kTopkThreads / kWarp;
  const int blocks = (T + per_block - 1) / per_block;
  if (bias != nullptr)
    moe_route_topk_kernel<true><<<blocks, kTopkThreads, 0, s>>>(
        logits, T, E, k, n_valid, ids, weights, counts, counter, bias,
        renormalize, scale);
  else
    moe_route_topk_kernel<false><<<blocks, kTopkThreads, 0, s>>>(
        logits, T, E, k, n_valid, ids, weights, counts, counter, bias,
        renormalize, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_route_place_kernel<<<held, kPlaceThreads, 0, s>>>(
      ids, T * k, k, first, counts, offs, pos, sorted_token);
  return static_cast<int>(cudaGetLastError());
}

// ys: (rows, H) bf16, rows 16-byte aligned (H % 8 == 0); pos: (T, k)
// int32 rows of ys (−1: none); w: (T, k) f32; shared: (T, H) bf16 or null; out:
// (T, H) bf16.  1 ≤ k ≤ 8.  Same launch contract as moe_route_launch.
extern "C" int moe_combine_launch(const void* ys, const int32_t* pos,
                                  const float* w, const void* shared, void* out,
                                  int T, int H, int k, void* stream) {
  if (T < 0 || H < 8 || H % 8 != 0 || k < 1 || k > kMaxTopK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* y = static_cast<const __nv_bfloat16*>(ys);
  const auto* sh = static_cast<const __nv_bfloat16*>(shared);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (shared != nullptr)
    moe_combine_kernel<true><<<T, kCombineThreads, 0, s>>>(y, pos, w, sh, o,
                                                           H, k);
  else
    moe_combine_kernel<false><<<T, kCombineThreads, 0, s>>>(y, pos, w, sh, o,
                                                            H, k);
  return static_cast<int>(cudaGetLastError());
}
