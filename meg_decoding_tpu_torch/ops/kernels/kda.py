"""Kimi Delta Attention's chunk (arXiv:2510.26692): the CUDA kernels
``csrc/kda.cu`` and their plain PyTorch versions.

``kda_chunk(q, k, v, g, beta, state)`` runs one chunk of C tokens of the
gated delta rule for every head, per head (d = 128):

  q ← q / √(‖q‖² + 1e-6) · d^−½,   k ← k / √(‖k‖² + 1e-6)   (f32)
  S_t = Diag(exp g_t) S_{t−1};  v'_t = β_t (v_t − S_tᵀ k_t);
  S_t += k_t v'_tᵀ;  o_t = S_tᵀ q_t

as flash-linear-attention's recurrent form writes it (decay first, then
the delta step): ``q``, ``k``, ``v`` (C, H, d) bf16 (rows of any stride,
each row's heads contiguous), ``g`` (C, H, d) f32 log-decays (≤ 0, a
decay per key channel), ``beta`` (C, H) f32, ``state`` (H, d, d) f32,
S[h, key, value], read and written in place.  Returns o (C, H, d) in q's
dtype.

**The chunked form** (the WY/UT transform, over sub-chunks of ``SUB`` =
64 tokens).  With G the cumulative log-decay from the sub-chunk's start
(f32) and S₀ the state there:

  A[i, j]   = β_i Σ_c k_i[c] k_j[c] exp(G_i[c] − G_j[c])   (j < i)
  Aqk[i, j] =     Σ_c q_i[c] k_j[c] exp(G_i[c] − G_j[c])   (j ≤ i)
  T = (I + A)⁻¹ (forward substitution);  W = T (β ⊙ k ⊙ e^G);
  U = T (β ⊙ v) − W S₀
  O = (q ⊙ e^G) S₀ + Aqk U
  S = e^{G_last} ⊙ S₀ + (k ⊙ e^{G_last − G})ᵀ U

Every exponent is ≤ 0 (G falls along the sub-chunk), so nothing
overflows however strong the decay; the pairs' factors are taken one
(i, j, c) at a time.  A chunk whose length is not a multiple of 64 ends
with a short sub-chunk, zero-padded inside: its padded rows add nothing.

The kernel (``csrc/kda.cu``) is two launches: ``kda_prep_kernel``, one
block a (sub-chunk, head), all in parallel, makes A, Aqk, T and the
sub-chunk's W, U′ = T(β ⊙ v), q ⊙ e^G, k ⊙ e^{G_last − G} and Aqk in
bf16 and e^{G_last} in f32 (a workspace the wrapper allocates);
``kda_state_kernel``, one block a (head, 32 value columns), walks the
sub-chunks in order with its slice of the state in shared memory and
runs the products with S₀ and U on the tensor cores (bf16 operands, f32
accumulation; the state itself stays f32).  ``kda_chunk_plain`` is the
same arithmetic in PyTorch, rounding where the kernel rounds when the
inputs are bf16 (and nowhere for f32 inputs); ``kda_recurrent`` is the
token recurrence above, in f32, the yardstick of both.

``short_conv(x, tail, weight)`` is the layer's causal depthwise
convolution of width K = 4 and its SiLU, in f32, rounded once: ``x`` (C,
D) the chunk's projections, ``tail`` (K − 1, D) the inputs before the
chunk (zeros at a document's start), ``weight`` (D, 1, K); it writes the
chunk's last K − 1 inputs into ``tail`` for the next chunk.  On the card
one launch of ``kda_conv_kernel``, and the tail's copy.

This kernel replaces no Pallas kernel: the JAX package has no language
model.  The wrapper launches the kernel for CUDA tensors and runs the
plain version only for CPU tensors.  ``launches`` counts the calls on the
card: ``kda_chunk`` (two kernels a call), ``kda_conv`` (one).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["SUB", "HEAD_DIM", "EPS", "CONV_K", "kda_chunk",
           "kda_chunk_plain", "kda_recurrent", "short_conv",
           "short_conv_plain", "l2_normalize", "launches", "reset_launches"]

SUB = 64          # tokens of a sub-chunk (csrc/kda.cu's kSub)
HEAD_DIM = 128    # the key and value size a head (csrc/kda.cu's kD)
EPS = 1e-6        # the L2 norm's, inside the square root
CONV_K = 4        # the short convolution's width (csrc/kda.cu's kConvK)

# kernel launches since the last reset_launches() (a replay of a captured
# forward adds what its capture counted, train/graph.py)
launches = {"kda_chunk": 0, "kda_conv": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / √(Σ x² + 1e-6) over the last dim, in f32 (fla's l2norm)."""
    x = x.float()
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + EPS)


def kda_recurrent(q, k, v, g, beta, state) -> torch.Tensor:
    """The token recurrence (module docstring) in f32, one token at a
    time; updates ``state`` in place, returns o (C, H, d) f32."""
    d = q.shape[-1]
    qn, kn = l2_normalize(q) * d ** -0.5, l2_normalize(k)
    vf, a, b = v.float(), g.float().exp(), beta.float()
    S = state.float()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    for t in range(q.shape[0]):
        S = S * a[t][:, :, None]
        u = b[t][:, None] * (vf[t] - torch.einsum("hkv,hk->hv", S, kn[t]))
        S = S + kn[t][:, :, None] * u[:, None, :]
        out[t] = torch.einsum("hkv,hk->hv", S, qn[t])
    state.copy_(S)
    return out


def kda_chunk_plain(q, k, v, g, beta, state) -> torch.Tensor:
    """The kernel's chunked arithmetic in PyTorch (module docstring);
    updates ``state`` in place."""
    C, H, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    rnd = (lambda t: t.bfloat16().float()) if bf16 else (lambda t: t)
    qn, kn = l2_normalize(q) * d ** -0.5, l2_normalize(k)
    out = torch.empty(C, H, d, dtype=q.dtype, device=q.device)
    S = state.float()
    for s in range(0, C, SUB):
        e = min(s + SUB, C)
        n = e - s
        Q, K = qn[s:e].transpose(0, 1), kn[s:e].transpose(0, 1)  # (H, n, d)
        V = v[s:e].float().transpose(0, 1)
        G = g[s:e].float().transpose(0, 1).cumsum(1)
        B = beta[s:e].float().T[:, :, None]                       # (H, n, 1)
        incl = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        diff = (G[:, :, None, :] - G[:, None, :, :]).clamp(max=0)
        E = torch.where(incl[None, :, :, None], diff.exp(), 0.0)
        KE = K[:, None, :, :] * E                                 # (H, i, j, c)
        A = (B * (KE * K[:, :, None, :]).sum(-1)).tril(-1)
        Aqk = (KE * Q[:, :, None, :]).sum(-1)
        eye = torch.eye(n, device=q.device).expand(H, n, n)
        T = rnd(torch.linalg.solve_triangular(eye + A, eye, upper=False,
                                              unitriangular=True))
        last = G[:, -1:, :]
        W = rnd(T @ rnd(B * K * G.exp()))
        U = rnd(T @ rnd(B * V)) - W @ rnd(S)
        Ub = rnd(U)
        O = rnd(Q * G.exp()) @ rnd(S) + rnd(Aqk) @ Ub
        S = last.exp().transpose(1, 2) * S \
            + rnd(K * (last - G).exp()).transpose(1, 2) @ Ub
        out[s:e] = O.transpose(0, 1).to(out.dtype)
    state.copy_(S)
    return out


def short_conv_plain(x, tail, weight) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch (module docstring): the products
    rounded, then added in tap order, in f32; updates ``tail``."""
    C, K = x.shape[0], weight.shape[-1]
    xx = torch.cat([tail, x]).float()
    w = weight.reshape(weight.shape[0], K).float()
    acc = xx[0:C] * w[:, 0]
    for j in range(1, K):
        acc = acc + xx[j:j + C] * w[:, j]
    tail.copy_(xx[C:])
    return torch.nn.functional.silu(acc).to(x.dtype)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# kernel → its launcher in the library and the launcher's arguments
_LAUNCHERS = {
    "kda_chunk": ("kda_chunk_launch",
                  [_PTR] * 3 + [_INT] + [_PTR] * 4 + [_INT, _INT]
                  + [_PTR] * 3),
    "kda_conv": ("kda_conv_launch", [_PTR] * 4 + [_INT, _INT, _PTR]),
}
_FNS: dict = {}


def _fn(kernel: str):
    fn = _FNS.get(kernel)
    if fn is None:
        from meg_decoding_tpu_torch.ops.kernels.build import load_library

        name, argtypes = _LAUNCHERS[kernel]
        fn = getattr(load_library("kda"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[kernel] = fn
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(q, k, v, g, beta, state) -> bool:
    """True for CPU tensors (the plain version's case); raises for a
    layout the kernel does not take."""
    C, H, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or g.shape != q.shape \
            or beta.shape != (C, H) or state.shape != (H, d, d):
        raise ValueError("kda_chunk: q, k, v, g (C, H, d), beta (C, H), "
                         "state (H, d, d)")
    if g.dtype != torch.float32 or beta.dtype != torch.float32 \
            or state.dtype != torch.float32:
        raise TypeError("kda_chunk: g, beta and state are float32")
    ts = (q, k, v, g, beta, state)
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError("kda_chunk: tensors on different devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"kda_chunk runs on cuda or cpu, not {dev}")
    if d != HEAD_DIM or q.dtype != torch.bfloat16 \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"kda_chunk's kernel takes bf16 q, k, v of "
                        f"{HEAD_DIM} a head")
    ld = q.stride(0)
    for t in (q, k, v):
        if t.stride() != (ld, d, 1) or t.data_ptr() % 16 or ld % 8:
            raise ValueError("kda_chunk: q, k, v share a row stride, each "
                             "row's heads contiguous, 16-byte aligned")
    if not all(t.is_contiguous() for t in (g, beta, state)):
        raise ValueError("kda_chunk: g, beta, state must be contiguous")
    return False


def kda_chunk(q, k, v, g, beta, state) -> torch.Tensor:
    """o (C, H, d) of one chunk (module docstring); updates ``state``."""
    if q.dim() != 3 or q.shape[0] < 1:
        raise ValueError("kda_chunk takes (C, H, d) with C ≥ 1")
    if _check(q, k, v, g, beta, state):
        return kda_chunk_plain(q, k, v, g, beta, state)
    C, H, d = q.shape
    n_sub = -(-C // SUB)
    dev = q.device
    ws_b = torch.empty(n_sub, H, 4 * SUB * d + SUB * SUB,
                       dtype=torch.bfloat16, device=dev)
    ws_f = torch.empty(n_sub, H, d, dtype=torch.float32, device=dev)
    out = torch.empty(C, H, d, dtype=torch.bfloat16, device=dev)
    err = _fn("kda_chunk")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), out.data_ptr(), C, H,
        ws_b.data_ptr(), ws_f.data_ptr(), _stream(q))
    if err != 0:
        raise RuntimeError(f"kda_chunk kernel launch failed: CUDA error {err}")
    launches["kda_chunk"] += 1
    return out


def short_conv(x, tail, weight) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of the chunk's rows ``x``
    (C, D) after ``tail`` (K − 1, D), by ``weight`` (D, 1, K): (C, D) in
    x's dtype; writes the chunk's last K − 1 inputs into ``tail``."""
    C, D = x.shape
    K = weight.shape[-1]
    if tail.shape != (K - 1, D) or weight.shape != (D, 1, K) \
            or tail.dtype != x.dtype or weight.dtype != x.dtype:
        raise ValueError("short_conv: x (C, D), tail (K − 1, D), weight "
                         "(D, 1, K), one dtype")
    dev = x.device
    if any(t.device != dev for t in (tail, weight)):
        raise ValueError("short_conv: tensors on different devices")
    if dev.type == "cpu":
        return short_conv_plain(x, tail, weight)
    if dev.type != "cuda":
        raise ValueError(f"short_conv runs on cuda or cpu, not {dev}")
    if x.dtype != torch.bfloat16 or K != CONV_K or D % 8 \
            or not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                       for t in (x, tail, weight)):
        raise ValueError(f"short_conv's kernel takes contiguous bf16 rows of "
                         f"a multiple of 8, 16-byte aligned, K = {CONV_K}")
    out = torch.empty(C, D, dtype=torch.bfloat16, device=dev)
    err = _fn("kda_conv")(x.data_ptr(), tail.data_ptr(), weight.data_ptr(),
                          out.data_ptr(), C, D, _stream(x))
    if err != 0:
        raise RuntimeError(f"kda_conv kernel launch failed: CUDA error {err}")
    launches["kda_conv"] += 1
    # the next chunk's tail: the last K − 1 inputs, once the kernel read it
    tail.copy_(torch.cat([tail, x])[C:] if C < K - 1 else x[C - K + 1:])
    return out
