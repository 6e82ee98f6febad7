// Kimi Delta Attention's chunk forward (the gated delta rule with a decay
// per key channel, arXiv:2510.26692) and its short convolution, for Hopper
// (sm_90a): the KDA layers of Kimi-Linear (features/kimi_linear_model.py),
// inference only.
//
//   per head (d = 128), tokens t of the chunk in order:
//     q̂ = q / sqrt(|q|² + 1e-6) · d^-1/2,  k̂ = k / sqrt(|k|² + 1e-6)
//     S = Diag(exp g_t) S;  v' = β_t (v_t − Sᵀ k̂_t);  S += k̂_t v'ᵀ;
//     o_t = Sᵀ q̂_t                                   (S: f32, d × d)
//
// computed in the chunked (WY / UT-transform) form over sub-chunks of 64
// tokens, with G the cumulative log-decay from the sub-chunk's start in
// f32 and S0 the state there:
//
//   A[i,j]   = β_i Σ_c k̂_i[c] k̂_j[c] exp(G_i[c] − G_j[c])    (j < i)
//   Aqk[i,j] =     Σ_c q̂_i[c] k̂_j[c] exp(G_i[c] − G_j[c])    (j ≤ i)
//   T = (I + A)^-1;  W = T (β ⊙ k̂ ⊙ e^G);  U = T (β ⊙ v) − W S0
//   O = (q̂ ⊙ e^G) S0 + Aqk U;  S = e^G_last ⊙ S0 + (k̂ ⊙ e^(G_last − G))ᵀ U
//
// Every exponent is ≤ 0, so no factor overflows whatever the decay.  The
// short convolution: out[t, c] = SiLU(Σ_j w[c, j] x[t − K + 1 + j, c]) in
// f32, rows before the chunk from the carried tail of K − 1 = 3 inputs.
//
// Replaces no TPU kernel: the JAX package has no language model.  No
// library call computes a delta rule; a token-by-token loop would run 2,048
// dependent steps a chunk a layer.
//
// Bound on an H100 SXM, a 2,048-token chunk of 32 heads: bytes, ~105 MB
// (q, k, v, o bf16, g f32, β, the state in and out) = 31 µs at 3.35 TB/s,
// against ~12 GFLOP of the chunk-64 form (12 µs at 989 TFLOP/s).  The
// convolution: bytes, 2 × 50 MB of (2,048, 12,288) bf16 rows, 30 µs.
//
// Design: two launches for the chunk.  kda_prep_kernel, one block of 512
// threads a (sub-chunk, head), all independent: loads q, k, g a row in
// 16-byte packets, normalises q and k, sums the decays (kept as base-2
// logarithms, so each factor is one ex2), forms A and Aqk (a warp a row, a
// lane a column, 4 channels a read: the rows of k and G are padded to 132
// floats so that 8 lanes' packets fall in distinct banks), solves for T
// blockwise (the four 16 × 16 diagonal blocks by forward substitution at
// once, then the blocks below them a block row at a time), and writes W,
// U′ = T(β ⊙ v),
// q̂ ⊙ e^G, k̂ ⊙ e^(G_last − G) and Aqk as bf16 (the products T·X on the
// tensor cores, bf16 operands, f32 accumulation) and e^G_last as f32.
// kda_state_kernel, one block a (32 value columns, head): the columns of
// the state evolve apart, so 4 blocks a head walk the sub-chunks in order,
// each holding its (128 × 32) f32 slice of the state in shared memory; the
// next sub-chunk's operands are copied in (cp.async) while the tensor cores
// run W·S0, (q̂ ⊙ e^G)·S0 + Aqk·U and (k̂ ⊙ e^(G_last − G))ᵀ·U (bf16
// operands: S0 and U rounded to bf16 for the products, the state's update
// accumulated in f32; every operand's rows padded in shared memory so a
// fragment's rows fall in distinct banks).  A chunk not a multiple of 64
// ends with a sub-chunk zero-padded in shared memory: its padded rows have
// k = q = v = 0, g = 0 and β = 0, and add nothing.  kda_conv_kernel: a thread 8 channels of 16
// rows, the window of 4 rows slid in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kD = 128;        // head size (keys and values)
constexpr int kSub = 64;       // tokens a sub-chunk
constexpr int kBlk = 16;       // rows of a block of the triangular solve
// padded rows in shared memory: k, q and G (f32, read 4 at a time: a row
// of 132 puts 8 consecutive rows' packets in distinct banks), A and T
// (f32, read one at a time), the tensor cores' bf16 operands (+8) and f32
// tiles (+4), so that a fragment's rows fall in distinct banks
constexpr int kP = kD + 4;
constexpr int kAP = kSub + 1;
constexpr int kLdD = kD + 8;     // bf16 rows of kD
constexpr int kLdS = kSub + 8;   // bf16 rows of kSub
constexpr int kLdV = 32 + 8;     // bf16 rows of kBV
constexpr int kLdF = 32 + 4;     // f32 rows of kBV
constexpr int kLdStage = 16 + 4; // f32 rows of a staging tile
constexpr int kBV = 32;        // value columns a state block
constexpr int kPrepThreads = 512;
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kStThreads = 256;
constexpr int kStWarps = kStThreads / 32;
constexpr float kEps = 1e-6f;
constexpr float kScale = 0.08838834764831845f;  // kD^-1/2
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kConvK = 4;      // the short convolution's width
constexpr int kConvRows = 16;  // rows a convolution thread
// the workspace, a (sub-chunk, head) block each: bf16 W, U', q̂e^G,
// k̂e^(G_last − G) (kSub × kD) and Aqk (kSub × kSub); f32 e^G_last (kD)
constexpr int kBlockB = 4 * kSub * kD + kSub * kSub;
constexpr int kOffU = kSub * kD, kOffQ = 2 * kSub * kD, kOffK = 3 * kSub * kD;
constexpr int kOffA = 4 * kSub * kD;

// kda_prep_kernel's shared memory (bytes)
constexpr int kPrepTb = 0;
constexpr int kPrepXb = kPrepTb + kSub * kLdS * 2;
constexpr int kPrepStage = kPrepXb + kSub * kLdD * 2;
constexpr int kPrepK = kPrepStage + kPrepWarps * 16 * kLdStage * 4;
constexpr int kPrepG = kPrepK + kSub * kP * 4;
constexpr int kPrepQ = kPrepG + kSub * kP * 4;
constexpr int kPrepA = kPrepQ + kSub * kP * 4;
constexpr int kPrepT = kPrepA + kSub * kAP * 4;
constexpr int kPrepB = kPrepT + kSub * kAP * 4;
constexpr int kPrepBytes = kPrepB + kSub * 4;

// kda_state_kernel's: two stages of the copied operands (Wb, Qb, Kb, Ab,
// U'b, gl), then Sb, Ub (bf16), S, Uf, Of (f32)
constexpr int kStgW = 0;
constexpr int kStgQ = kStgW + kSub * kLdD * 2;
constexpr int kStgK = kStgQ + kSub * kLdD * 2;
constexpr int kStgA = kStgK + kSub * kLdD * 2;
constexpr int kStgU = kStgA + kSub * kLdS * 2;
constexpr int kStgGl = kStgU + kSub * kBV * 2;
constexpr int kStage = kStgGl + kD * 4;
constexpr int kStSb = 2 * kStage;
constexpr int kStUb = kStSb + kD * kLdV * 2;
constexpr int kStS = kStUb + kSub * kLdV * 2;
constexpr int kStUf = kStS + kD * kLdF * 4;
constexpr int kStO = kStUf + kSub * kLdF * 4;
constexpr int kStBytes = kStO + kSub * kLdF * 4;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> FragAT;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 2^x (the ex2 unit; x ≤ 0 here, far below −126 gives 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(b[e]);
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) b[e] = __float2bfloat16_rn(f[e]);
  return u;
}

// 16-byte copies from global to shared memory that do not wait (cp.async)
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// out (kSub × kD bf16, row stride kD) = Tb (kSub × kSub, row stride kLdS)
// · Xb (kSub × kD, row stride kLdD), 2 output tiles a warp, through the
// warp's f32 staging tile
__device__ void prep_product(const __nv_bfloat16* Tb,
                             const __nv_bfloat16* Xb, float* stage,
                             __nv_bfloat16* out, int warp, int lane) {
  for (int tile = warp; tile < (kSub / 16) * (kD / 16); tile += kPrepWarps) {
    const int r = tile / (kD / 16), cb = tile % (kD / 16);
    FragA fa;
    FragB fb;
    FragC fc;
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      wmma::load_matrix_sync(fa, Tb + r * 16 * kLdS + kk * 16, kLdS);
      wmma::load_matrix_sync(fb, Xb + kk * 16 * kLdD + cb * 16, kLdD);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(stage, fc, kLdStage, wmma::mem_row_major);
    __syncwarp();
    // a lane 8 columns of a row: 16 rows × 2 packets
    const int row = lane >> 1, half = lane & 1;
    *reinterpret_cast<uint4*>(out + (r * 16 + row) * kD + cb * 16 +
                              half * 8) =
        pack8(stage + row * kLdStage + half * 8);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kPrepThreads)
    kda_prep_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, int64_t ld,
                    const float* __restrict__ g,
                    const float* __restrict__ beta, int C, int H,
                    __nv_bfloat16* __restrict__ ws_b,
                    float* __restrict__ ws_f) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Tb = reinterpret_cast<__nv_bfloat16*>(smem + kPrepTb);
  auto* Xb = reinterpret_cast<__nv_bfloat16*>(smem + kPrepXb);
  auto* stage_all = reinterpret_cast<float*>(smem + kPrepStage);
  auto* sK = reinterpret_cast<float*>(smem + kPrepK);
  auto* sG = reinterpret_cast<float*>(smem + kPrepG);
  auto* sQ = reinterpret_cast<float*>(smem + kPrepQ);
  auto* sA = reinterpret_cast<float*>(smem + kPrepA);
  auto* sT = reinterpret_cast<float*>(smem + kPrepT);
  auto* sB = reinterpret_cast<float*>(smem + kPrepB);
  const int sub = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = sub * kSub;
  const int n = min(kSub, C - t0);
  __nv_bfloat16* ws = ws_b + (static_cast<size_t>(sub) * H + h) * kBlockB;
  float* wsGl = ws_f + (static_cast<size_t>(sub) * H + h) * kD;
  float* stage = stage_all + warp * 16 * kLdStage;

  // q, k a packet of 8 channels, g of 4; rows past the chunk are zeros
  for (int idx = tid; idx < kSub * (kD / 8); idx += kPrepThreads) {
    const int i = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    float kf[8], qf[8];
    if (i < n) {
      const int64_t at = static_cast<int64_t>(t0 + i) * ld + h * kD + c;
      unpack8(*reinterpret_cast<const uint4*>(k + at), kf);
      unpack8(*reinterpret_cast<const uint4*>(q + at), qf);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = qf[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sK[i * kP + c + e] = kf[e];
      sQ[i * kP + c + e] = qf[e];
    }
  }
  for (int idx = tid; idx < kSub * (kD / 4); idx += kPrepThreads) {
    const int i = idx / (kD / 4), c = (idx % (kD / 4)) * 4;
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n)
      gv = *reinterpret_cast<const float4*>(
          g + (static_cast<int64_t>(t0 + i) * H + h) * kD + c);
    sG[i * kP + c] = gv.x;
    sG[i * kP + c + 1] = gv.y;
    sG[i * kP + c + 2] = gv.z;
    sG[i * kP + c + 3] = gv.w;
  }
  for (int idx = tid; idx < kSub * kAP; idx += kPrepThreads) {
    const int i = idx / kAP, j = idx % kAP;
    sA[idx] = 0.f;
    sT[idx] = i == j ? 1.f : 0.f;
  }
  if (tid < kSub)
    sB[tid] = tid < n ? beta[static_cast<int64_t>(t0 + tid) * H + h] : 0.f;
  __syncthreads();

  // q and k normalised a row (one warp a row); the decays summed a channel,
  // kept as base-2 logarithms
  for (int i = warp; i < kSub; i += kPrepWarps) {
    float sk = 0.f, sq = 0.f;
    for (int c = lane; c < kD; c += 32) {
      sk = fmaf(sK[i * kP + c], sK[i * kP + c], sk);
      sq = fmaf(sQ[i * kP + c], sQ[i * kP + c], sq);
    }
    const float rk = rsqrtf(warp_sum(sk) + kEps);
    const float rq = rsqrtf(warp_sum(sq) + kEps) * kScale;
    for (int c = lane; c < kD; c += 32) {
      sK[i * kP + c] *= rk;
      sQ[i * kP + c] *= rq;
    }
  }
  if (tid < kD) {
    float acc = 0.f;
    for (int i = 0; i < kSub; ++i) {
      acc += sG[i * kP + tid];
      sG[i * kP + tid] = acc * kLog2e;
    }
  }
  __syncthreads();

  // A and Aqk: a unit is a row i and 32 columns j (a lane each)
  __nv_bfloat16* wsA = ws + kOffA;
  for (int unit = warp; unit < kSub + kSub / 2; unit += kPrepWarps) {
    const int i = unit < kSub ? unit : unit - kSub / 2;
    const int j = (unit < kSub ? 0 : 32) + lane;
    const float4* Ki = reinterpret_cast<const float4*>(sK + i * kP);
    const float4* Qi = reinterpret_cast<const float4*>(sQ + i * kP);
    const float4* Gi = reinterpret_cast<const float4*>(sG + i * kP);
    const float4* Kj = reinterpret_cast<const float4*>(sK + j * kP);
    const float4* Gj = reinterpret_cast<const float4*>(sG + j * kP);
    float a = 0.f, b = 0.f;
#pragma unroll 4
    for (int c = 0; c < kD / 4; ++c) {
      const float4 kj = Kj[c], gj = Gj[c], ki = Ki[c], qi = Qi[c],
                   gi = Gi[c];
      const float k0 = kj.x * exp2_fast(fminf(gi.x - gj.x, 0.f));
      const float k1 = kj.y * exp2_fast(fminf(gi.y - gj.y, 0.f));
      const float k2 = kj.z * exp2_fast(fminf(gi.z - gj.z, 0.f));
      const float k3 = kj.w * exp2_fast(fminf(gi.w - gj.w, 0.f));
      a = fmaf(ki.x, k0, a);
      b = fmaf(qi.x, k0, b);
      a = fmaf(ki.y, k1, a);
      b = fmaf(qi.y, k1, b);
      a = fmaf(ki.z, k2, a);
      b = fmaf(qi.z, k2, b);
      a = fmaf(ki.w, k3, a);
      b = fmaf(qi.w, k3, b);
    }
    if (j < i) sA[i * kAP + j] = sB[i] * a;
    wsA[i * kSub + j] = __float2bfloat16_rn(j <= i ? b : 0.f);
  }
  for (int idx = tid; idx < 32 * 32; idx += kPrepThreads)
    wsA[(idx / 32) * kSub + 32 + idx % 32] = __float2bfloat16_rn(0.f);
  __syncthreads();

  // T = (I + A)^-1, blockwise.  The diagonal blocks first, by forward
  // substitution, all four at once: 8 threads a column of a block.
  {
    const int blk = tid >> 7, col = (tid >> 3) & 15, p = tid & 7;
    const int base = blk * kBlk, j = base + col;
    for (int r = 1; r < kBlk; ++r) {
      const int i = base + r;
      float s = 0.f;
      if (col < r)
        for (int m = j + 1 + p; m < i; m += 8)
          s = fmaf(sA[i * kAP + m], sT[m * kAP + j], s);
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      s += __shfl_xor_sync(kFull, s, 4);
      if (col < r && p == 0) sT[i * kAP + j] = -sA[i * kAP + j] - s;
      __syncthreads();
    }
  }
  // then each block row I below the diagonal: X_J = Σ_{J ≤ M < I} A_IM T_MJ
  // for every J < I, and T_IJ = −T_II X_J (X in the staging area)
  for (int I = 1; I < kSub / kBlk; ++I) {
    for (int idx = tid; idx < I * kBlk * kBlk; idx += kPrepThreads) {
      const int J = idx / (kBlk * kBlk), r = (idx / kBlk) % kBlk,
                c = idx % kBlk;
      const int i = I * kBlk + r, j = J * kBlk + c;
      float s = 0.f;
      for (int m = J * kBlk; m < I * kBlk; ++m)
        s = fmaf(sA[i * kAP + m], sT[m * kAP + j], s);
      stage_all[idx] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < I * kBlk * kBlk; idx += kPrepThreads) {
      const int J = idx / (kBlk * kBlk), r = (idx / kBlk) % kBlk,
                c = idx % kBlk;
      const int i = I * kBlk + r;
      float s = 0.f;
      for (int m = 0; m <= r; ++m)
        s = fmaf(sT[i * kAP + I * kBlk + m],
                 stage_all[J * kBlk * kBlk + m * kBlk + c], s);
      sT[i * kAP + J * kBlk + c] = -s;
    }
    __syncthreads();
  }

  // q̂ e^G and k̂ e^(G_last − G) out; β k̂ e^G and T in bf16 for W; a thread
  // a packet of 8 channels of a row
  const float* Gl = sG + (kSub - 1) * kP;
  for (int idx = tid; idx < kSub * (kD / 8); idx += kPrepThreads) {
    const int i = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    float qo[8], ko[8], xo[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float G = sG[i * kP + c + e], ex = exp2_fast(G);
      const float kk = sK[i * kP + c + e];
      qo[e] = sQ[i * kP + c + e] * ex;
      ko[e] = kk * exp2_fast(fminf(Gl[c + e] - G, 0.f));
      xo[e] = sB[i] * kk * ex;
    }
    *reinterpret_cast<uint4*>(ws + kOffQ + i * kD + c) = pack8(qo);
    *reinterpret_cast<uint4*>(ws + kOffK + i * kD + c) = pack8(ko);
    *reinterpret_cast<uint4*>(Xb + i * kLdD + c) = pack8(xo);
  }
  for (int idx = tid; idx < kSub * kSub; idx += kPrepThreads) {
    const int i = idx / kSub, j = idx % kSub;
    Tb[i * kLdS + j] = __float2bfloat16_rn(j <= i ? sT[i * kAP + j] : 0.f);
  }
  if (tid < kD) wsGl[tid] = exp2_fast(Gl[tid]);
  __syncthreads();
  prep_product(Tb, Xb, stage, ws, warp, lane);
  __syncthreads();
  for (int idx = tid; idx < kSub * (kD / 8); idx += kPrepThreads) {
    const int i = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    float vf[8];
    if (i < n)
      unpack8(*reinterpret_cast<const uint4*>(
                  v + static_cast<int64_t>(t0 + i) * ld + h * kD + c),
              vf);
    else
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) vf[e] *= sB[i];
    *reinterpret_cast<uint4*>(Xb + i * kLdD + c) = pack8(vf);
  }
  __syncthreads();
  prep_product(Tb, Xb, stage, ws + kOffU, warp, lane);
}

// the copies of one sub-chunk's operands into a stage of shared memory
__device__ __forceinline__ void state_fetch(unsigned char* stg,
                                           const __nv_bfloat16* ws,
                                           const float* gl, int j0, int tid) {
  const uint4* src = reinterpret_cast<const uint4*>(ws);
  // W, q̂e^G, k̂e^(G_last − G): kSub·kD/8 packets each, into padded rows;
  // Aqk kSub·kSub/8
  for (int e = tid; e < kSub * kD / 8; e += kStThreads) {
    const int at = ((e / (kD / 8)) * kLdD + (e % (kD / 8)) * 8) * 2;
    cp16(stg + kStgW + at, src + e);
    cp16(stg + kStgQ + at, src + kOffQ / 8 + e);
    cp16(stg + kStgK + at, src + kOffK / 8 + e);
  }
  for (int e = tid; e < kSub * kSub / 8; e += kStThreads)
    cp16(stg + kStgA + ((e / (kSub / 8)) * kLdS + (e % (kSub / 8)) * 8) * 2,
         src + kOffA / 8 + e);
  // U′'s 32 columns of this block: 4 packets a row
  for (int e = tid; e < kSub * kBV / 8; e += kStThreads) {
    const int row = e / (kBV / 8), pk = e % (kBV / 8);
    cp16(stg + kStgU + e * 16, ws + kOffU + row * kD + j0 + pk * 8);
  }
  if (tid < kD / 4) cp16(stg + kStgGl + tid * 16, gl + tid * 4);
}

__global__ void __launch_bounds__(kStThreads)
    kda_state_kernel(const __nv_bfloat16* __restrict__ ws_b,
                     const float* __restrict__ ws_f, float* state,
                     __nv_bfloat16* __restrict__ out, int C, int H,
                     int n_sub) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* Sb = reinterpret_cast<__nv_bfloat16*>(smem + kStSb);
  auto* Ub = reinterpret_cast<__nv_bfloat16*>(smem + kStUb);
  auto* S = reinterpret_cast<float*>(smem + kStS);
  auto* Uf = reinterpret_cast<float*>(smem + kStUf);
  auto* Of = reinterpret_cast<float*>(smem + kStO);
  const int j0 = blockIdx.x * kBV, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* st = state + static_cast<size_t>(h) * kD * kD;
  for (int idx = tid; idx < kD * kBV; idx += kStThreads)
    S[(idx / kBV) * kLdF + idx % kBV] =
        st[(idx / kBV) * kD + j0 + idx % kBV];
  // this warp's output tile of U and O (64 × 32: 4 × 2 tiles), and its
  // row block of the state (128 × 32: 8 row blocks of 2 tiles)
  const int r = warp / 2, cb = warp % 2, rr = warp;

  state_fetch(smem, ws_b + static_cast<size_t>(h) * kBlockB,
              ws_f + static_cast<size_t>(h) * kD, j0, tid);
  cp_commit();
  for (int sub = 0; sub < n_sub; ++sub) {
    if (sub + 1 < n_sub) {
      const size_t blk = static_cast<size_t>(sub + 1) * H + h;
      state_fetch(smem + ((sub + 1) & 1) * kStage, ws_b + blk * kBlockB,
                  ws_f + blk * kD, j0, tid);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    unsigned char* stg = smem + (sub & 1) * kStage;
    auto* Wb = reinterpret_cast<const __nv_bfloat16*>(stg + kStgW);
    auto* Qb = reinterpret_cast<const __nv_bfloat16*>(stg + kStgQ);
    auto* Kb = reinterpret_cast<const __nv_bfloat16*>(stg + kStgK);
    auto* Ab = reinterpret_cast<const __nv_bfloat16*>(stg + kStgA);
    auto* U0 = reinterpret_cast<const __nv_bfloat16*>(stg + kStgU);
    auto* gl = reinterpret_cast<const float*>(stg + kStgGl);
    const int t0 = sub * kSub, n = min(kSub, C - t0);
    for (int idx = tid; idx < kSub * kBV; idx += kStThreads)
      Uf[(idx / kBV) * kLdF + idx % kBV] = __bfloat162float(U0[idx]);
    for (int idx = tid; idx < kD * kBV; idx += kStThreads)
      Sb[(idx / kBV) * kLdV + idx % kBV] =
          __float2bfloat16_rn(S[(idx / kBV) * kLdF + idx % kBV]);
    __syncthreads();

    FragA fa;
    FragAT ft;
    FragB fb;
    FragC fc, fu;
    // U = U' − W·S0
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::load_matrix_sync(fa, Wb + r * 16 * kLdD + kk * 16, kLdD);
      wmma::load_matrix_sync(fb, Sb + kk * 16 * kLdV + cb * 16, kLdV);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    float* ut = Uf + r * 16 * kLdF + cb * 16;
    wmma::load_matrix_sync(fu, ut, kLdF, wmma::mem_row_major);
#pragma unroll
    for (int e = 0; e < fu.num_elements; ++e) fu.x[e] -= fc.x[e];
    wmma::store_matrix_sync(ut, fu, kLdF, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = r * 16 + e / 16, col = cb * 16 + e % 16;
      Ub[row * kLdV + col] = __float2bfloat16_rn(Uf[row * kLdF + col]);
    }
    __syncthreads();

    // O = (q̂ e^G)·S0 + Aqk·U, rows below n out
    wmma::fill_fragment(fc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::load_matrix_sync(fa, Qb + r * 16 * kLdD + kk * 16, kLdD);
      wmma::load_matrix_sync(fb, Sb + kk * 16 * kLdV + cb * 16, kLdV);
      wmma::mma_sync(fc, fa, fb, fc);
    }
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      wmma::load_matrix_sync(fa, Ab + r * 16 * kLdS + kk * 16, kLdS);
      wmma::load_matrix_sync(fb, Ub + kk * 16 * kLdV + cb * 16, kLdV);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    float* ot = Of + r * 16 * kLdF + cb * 16;
    wmma::store_matrix_sync(ot, fc, kLdF, wmma::mem_row_major);
    __syncwarp();
    {
      const int row = lane >> 1, half = lane & 1, i = r * 16 + row;
      if (i < n)
        *reinterpret_cast<uint4*>(
            out + (static_cast<int64_t>(t0 + i) * H + h) * kD + j0 +
            cb * 16 + half * 8) = pack8(ot + row * kLdF + half * 8);
    }

    // S = e^G_last ⊙ S0 + (k̂ e^(G_last − G))ᵀ·U, this warp's 16 rows
    for (int e = lane; e < 16 * kBV; e += 32) {
      const int row = rr * 16 + e / kBV;
      S[row * kLdF + e % kBV] *= gl[row];
    }
    __syncwarp();
#pragma unroll
    for (int c2 = 0; c2 < kBV / 16; ++c2) {
      float* stile = S + rr * 16 * kLdF + c2 * 16;
      wmma::load_matrix_sync(fc, stile, kLdF, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        wmma::load_matrix_sync(ft, Kb + kk * 16 * kLdD + rr * 16, kLdD);
        wmma::load_matrix_sync(fb, Ub + kk * 16 * kLdV + c2 * 16, kLdV);
        wmma::mma_sync(fc, ft, fb, fc);
      }
      wmma::store_matrix_sync(stile, fc, kLdF, wmma::mem_row_major);
    }
    __syncthreads();  // the next sub-chunk rewrites Sb, Uf, Ub and a stage
  }
  for (int idx = tid; idx < kD * kBV; idx += kStThreads)
    st[(idx / kBV) * kD + j0 + idx % kBV] =
        S[(idx / kBV) * kLdF + idx % kBV];
}

__global__ void kda_conv_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ tail,
                                const __nv_bfloat16* __restrict__ w,
                                __nv_bfloat16* __restrict__ out, int C,
                                int D) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * 8;
  const int t0 = blockIdx.y * kConvRows;
  if (c >= D) return;
  float wf[kConvK][8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int j = 0; j < kConvK; ++j)
      wf[j][e] = __bfloat162float(w[(c + e) * kConvK + j]);
  // the window: rows t0 − 3 .. t0, the rows before the chunk from the tail
  float win[kConvK][8];
#pragma unroll
  for (int j = 0; j < kConvK - 1; ++j) {
    const int row = t0 - (kConvK - 1) + j;
    const __nv_bfloat16* src =
        row < 0 ? tail + static_cast<int64_t>(row + kConvK - 1) * D + c
                : x + static_cast<int64_t>(row) * D + c;
    unpack8(*reinterpret_cast<const uint4*>(src), win[j + 1]);
  }
  for (int t = t0; t < min(t0 + kConvRows, C); ++t) {
#pragma unroll
    for (int j = 0; j < kConvK - 1; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) win[j][e] = win[j + 1][e];
    unpack8(*reinterpret_cast<const uint4*>(x + static_cast<int64_t>(t) * D +
                                            c),
            win[kConvK - 1]);
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float acc = __fmul_rn(win[0][e], wf[0][e]);
#pragma unroll
      for (int j = 1; j < kConvK; ++j)
        acc = __fadd_rn(acc, __fmul_rn(win[j][e], wf[j][e]));
      o[e] = acc / (1.f + expf(-acc));
    }
    *reinterpret_cast<uint4*>(out + static_cast<int64_t>(t) * D + c) =
        pack8(o);
  }
}

}  // namespace

// q, k, v: C rows of H·128 bf16, row stride ld elements (ld % 8 == 0,
// 16-byte aligned); g: (C, H, 128) f32; beta: (C, H) f32; state: (H, 128,
// 128) f32, read and written; out: (C, H, 128) bf16; ws_b: ⌈C/64⌉·H·
// (4·64·128 + 64·64) bf16 and ws_f: ⌈C/64⌉·H·128 f32 scratch.  Launches
// on stream without a sync; returns the CUDA error of an attribute call or
// a launch (0 on success).
extern "C" int kda_chunk_launch(const void* q, const void* k, const void* v,
                                int ld, const float* g, const float* beta,
                                float* state, void* out, int C, int H,
                                void* ws_b, float* ws_f, void* stream) {
  if (C < 1 || H < 1 || H > 65535 || ld < H * kD || ld % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attributes_set = false;
  cudaError_t err;
  if (!attributes_set) {
    err = cudaFuncSetAttribute(kda_prep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPrepBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kda_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attributes_set = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_sub = (C + kSub - 1) / kSub;
  kda_prep_kernel<<<dim3(n_sub, H), kPrepThreads, kPrepBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ld, g, beta, C, H,
      static_cast<__nv_bfloat16*>(ws_b), ws_f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kda_state_kernel<<<dim3(kD / kBV, H), kStThreads, kStBytes, s>>>(
      static_cast<const __nv_bfloat16*>(ws_b), ws_f, state,
      static_cast<__nv_bfloat16*>(out), C, H, n_sub);
  return static_cast<int>(cudaGetLastError());
}

// x: (C, D) bf16 rows (the chunk's projections), tail: (3, D) bf16 (the
// inputs before the chunk), w: (D, 4) bf16, out: (C, D) bf16; D % 8 == 0,
// every pointer 16-byte aligned.  Same launch contract.
extern "C" int kda_conv_launch(const void* x, const void* tail, const void* w,
                               void* out, int C, int D, void* stream) {
  if (C < 1 || D < 8 || D % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const dim3 grid((D / 8 + threads - 1) / threads,
                  (C + kConvRows - 1) / kConvRows);
  kda_conv_kernel<<<grid, threads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(tail),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), C, D);
  return static_cast<int>(cudaGetLastError());
}
