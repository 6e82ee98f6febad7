"""Exact per-row percentiles: the CUDA kernel ``csrc/robust_quantiles.cu``
and its plain PyTorch version.

Port of ``meg_decoding_tpu/ops/pallas/quantile.py``.  The collate chain's
RobustScaler needs the 25/50/75th percentiles of every (sample, channel)
row over the time axis, with ``numpy.percentile(method='linear')``
semantics under the total float order of XLA's sort (sign-flipped int32
keys: −NaN < −inf < … < −0 < +0 < … < +inf < +NaN).

* The kernel has three routes by row length (``kernel_route``).  A row of
  up to ``REGISTER_MAX_T`` keys is sorted in registers by a warp-wide
  bitonic network (one warp a row) and the order statistics are read from
  the lanes that hold them; a row of up to ``SHARED_MAX_T`` keys is kept in
  shared memory and each order statistic found by bisection over the key
  space; a longer row (a whole recording, as the Brennan build scales
  them) stays in global memory and takes a radix select, 11, 11 and 10
  bits of the key in three passes of one kernel each, its rows spread over
  many CTAs: two full reads of the row, then only the keys that share a
  target's 11-bit prefix, which the second read compacts into a candidate
  list (a row whose list would pass ``T // 4`` keys is read a third time
  instead).  All blend in f32.
* The plain version sorts the flipped int32 KEYS with ``torch.sort`` (a
  float sort would put every NaN last and tie ±0), then applies the same
  blend.
* The blend is ``fma(v_lo, w_lo, v_hi·w_hi)`` with f32 weights, the form
  XLA gives the JAX kernel's ``v_lo·w_lo + v_hi·w_hi`` on the CPU.  The
  kernel calls ``fmaf``; the plain version forms the exact product in f64
  and rounds the sum once to f32, which equals ``fmaf`` except where the
  f64 sum itself rounds onto an f32 rounding midpoint (≤ 1 ulp apart then).

``robust_quantiles`` calls the custom op
``meg_decoding_tpu_torch::robust_quantiles`` (``OP``), whose CUDA kernel is
the launch and whose CPU kernel is the plain version: it launches the
kernel for a CUDA tensor and runs the plain version only for a CPU tensor.
Its fake kernel gives the output's shape, so ``torch.export`` keeps the
hand-written kernel inside an exported program (``serving/export.py``).
Eager callers and exported programs take this one route, and each launch
counts once.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["robust_quantiles", "robust_quantiles_plain", "ranks_and_weights",
           "kernel_route", "REGISTER_MAX_T", "SHARED_MAX_T", "LONG_PASSES",
           "long_candidate_stride", "long_scratch_words", "long_candidates",
           "launches", "long_launches", "reset_launches", "OP", "OP_NAME"]

_I32_MAX = int(np.iinfo(np.int32).max)
_MAX_QUANTILES = 4
_MAX_TARGETS = 2 * _MAX_QUANTILES  # kMaxTargets: order statistics k and k + 1
# longest row the kernel sorts in registers (kRegisterMaxT in the source)
REGISTER_MAX_T = 1024
# longest row kept in the opt-in shared memory (kSharedMaxT)
SHARED_MAX_T = (227 * 1024) // 4
# the global-memory path's kernels a call (kLongPasses) and its scratch
# layout (kDigitBins, kStateWords, kStateTotal, kCandidateDiv)
LONG_PASSES = 3
_DIGIT_BINS = 2048
_STATE_WORDS = 32
_STATE_TOTAL = 2 * _MAX_TARGETS
_CANDIDATE_DIV = 4

# wrapper calls since the last reset_launches() that launched the register
# or shared-memory kernel (``launches``) and the global-memory radix select
# (``long_launches``, one a call for its LONG_PASSES kernels); a replay of a
# captured train step adds what its capture counted (train/graph.py)
launches = 0
long_launches = 0

# The global-memory path's zeroed scratch (histograms, tickets, list
# tails), kept per (device, stream): the kernels leave it zero, so it is
# zeroed once and every later call on the same stream reuses it.  It
# belongs to the stream it was made on (two streams sharing it would race),
# grows when a call needs more, and is dropped when a launch fails.
_ZEROED: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    global launches, long_launches
    launches = long_launches = 0


def kernel_route(T: int) -> str:
    """The kernel path a CUDA row of ``T`` keys takes: ``"register"``,
    ``"shared"`` or ``"global"`` (any longer row)."""
    if T <= REGISTER_MAX_T:
        return "register"
    return "shared" if T <= SHARED_MAX_T else "global"


def ranks_and_weights(T: int, qs) -> list[tuple[int, float, float, bool]]:
    """Per quantile: (order statistic, f32 weight of it, f32 weight of the
    next one, whether to interpolate) — the Pallas kernel's host constants
    (``pos = q/100·(T−1)``, rank ⌊pos⌋, weights rounded to f32 first)."""
    out = []
    for q in qs:
        pos = float(q) / 100.0 * (T - 1)
        frac = pos - np.floor(pos)
        out.append((int(np.floor(pos)), float(np.float32(1.0 - frac)),
                    float(np.float32(frac)), bool(frac != 0.0)))
    return out


def long_candidate_stride(T: int) -> int:
    """Keys of a row's candidate region, the cap on its list:
    ``T // kCandidateDiv`` rounded down to whole 16-byte vectors."""
    return (T // _CANDIDATE_DIV) & ~3


def long_scratch_words(N: int, T: int, n_quantiles: int) -> tuple[int, int]:
    """int32 words of the global-memory path's scratch for ``N`` rows of
    ``T`` keys: (zeroed, work).  Zeroed, zero on entry and left zero: per
    row a histogram of kDigitBins bins for each of the 2·n targets, a
    ticket and its list's tail.  Work: per row its state and its candidate
    region."""
    zeroed = N * (2 * n_quantiles * _DIGIT_BINS + 2)
    return zeroed, N * (_STATE_WORDS + long_candidate_stride(T))


def _flip(b: torch.Tensor) -> torch.Tensor:
    """float32 bits (as int32) → monotonically ordered int32 keys (an
    involution: it also maps keys back to bits)."""
    return torch.where(b < 0, b ^ _I32_MAX, b)


def robust_quantiles_plain(x2d: torch.Tensor,
                           qs: tuple = (25.0, 50.0, 75.0)) -> torch.Tensor:
    """Sort-based version: (N, T) f32 → (N, len(qs)) f32."""
    keys, _ = torch.sort(_flip(x2d.contiguous().view(torch.int32)), dim=-1)
    cols = []
    for rank, w_lo, w_hi, interp in ranks_and_weights(x2d.shape[1], qs):
        v_lo = _flip(keys[:, rank]).view(torch.float32)
        if not interp:
            cols.append(v_lo)
            continue
        v_hi = _flip(keys[:, rank + 1]).view(torch.float32)
        cols.append((v_lo.double() * w_lo + (v_hi * w_hi).double()).float())
    return torch.stack(cols, dim=1)


class _QuantileSpec(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int),
                ("rank", ctypes.c_int * _MAX_QUANTILES),
                ("interp", ctypes.c_int * _MAX_QUANTILES),
                ("w_lo", ctypes.c_float * _MAX_QUANTILES),
                ("w_hi", ctypes.c_float * _MAX_QUANTILES)]


def _lib():
    from meg_decoding_tpu_torch.ops.kernels.build import load_library

    lib = load_library("robust_quantiles")
    fn, long_fn = lib.robust_quantiles_launch, lib.robust_quantiles_long_launch
    if fn.argtypes is None:
        fn.restype = long_fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(_QuantileSpec),
                       ctypes.c_void_p]
        long_fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_longlong, ctypes.POINTER(_QuantileSpec),
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn, long_fn


def _check(x2d: torch.Tensor, qs) -> None:
    if x2d.dim() != 2 or x2d.shape[1] < 1:
        raise ValueError(f"expected (N, T ≥ 1), got {tuple(x2d.shape)}")
    if x2d.dtype != torch.float32:
        raise TypeError(f"robust_quantiles takes float32, got {x2d.dtype}")
    if not 1 <= len(qs) <= _MAX_QUANTILES:
        raise ValueError(f"1 to {_MAX_QUANTILES} quantiles, got {len(qs)}")


def _launch_rows(x2d: torch.Tensor, qs):
    """The kernel on a CUDA tensor, on the current stream: (out, the
    global-memory path's work scratch, or None on the other routes)."""
    _check(x2d, qs)
    if not x2d.is_cuda:
        raise ValueError(f"the robust_quantiles kernel runs on cuda, not {x2d.device}")
    N, T = x2d.shape
    if not x2d.is_contiguous():
        raise ValueError("x2d must be contiguous")
    spec = _QuantileSpec()
    spec.n = len(qs)
    for j, (rank, w_lo, w_hi, interp) in enumerate(ranks_and_weights(T, qs)):
        spec.rank[j], spec.interp[j] = rank, int(interp)
        spec.w_lo[j], spec.w_hi[j] = w_lo, w_hi
    out = torch.empty((N, len(qs)), dtype=torch.float32, device=x2d.device)
    stream = torch.cuda.current_stream(x2d.device).cuda_stream
    fn, long_fn = _lib()
    long_rows = kernel_route(T) == "global"
    work = None
    if not long_rows:
        err = fn(x2d.data_ptr(), out.data_ptr(), N, T, ctypes.byref(spec),
                 stream)
    else:
        # the zeroed scratch outlives the call, so a graph must not hold
        # it: no captured program has rows this long (a serving or eval
        # collate's rows hold one window's keys, 360 at the speech shape)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"rows of {T} keys take the global-memory "
                               "path, which is not captured in a CUDA graph")
        n_zeroed, n_work = long_scratch_words(N, T, len(qs))
        key = (x2d.device.index, stream)
        zeroed = _ZEROED.get(key)
        if zeroed is None or zeroed.numel() < n_zeroed:
            zeroed = _ZEROED[key] = torch.zeros(
                n_zeroed, dtype=torch.int32, device=x2d.device)
        work = torch.empty(n_work, dtype=torch.int32, device=x2d.device)
        err = long_fn(x2d.data_ptr(), out.data_ptr(), N, T,
                      ctypes.byref(spec), zeroed.data_ptr(), work.data_ptr(),
                      stream)
        if err != 0:
            del _ZEROED[key]
    if err != 0:
        raise RuntimeError(
            f"robust_quantiles kernel launch failed: CUDA error {err}")
    global launches, long_launches
    if long_rows:
        long_launches += 1
    else:
        launches += 1
    return out, work


def _launch(x2d: torch.Tensor, qs) -> torch.Tensor:
    """The kernel on a CUDA tensor, on the current stream."""
    return _launch_rows(x2d, qs)[0]


def long_candidates(x2d: torch.Tensor,
                    qs: tuple = (25.0, 50.0, 75.0)) -> torch.Tensor:
    """One call of the global-memory path on CUDA rows (counted in
    ``long_launches``), and per row the keys its second read wrote to the
    row's candidate list: an (N,) int32 tensor, −1 where the list would
    have passed the cap and the row was read a third time instead."""
    if kernel_route(x2d.shape[1]) != "global":
        raise ValueError(f"rows of {x2d.shape[1]} keys do not take the "
                         "global-memory path")
    _, work = _launch_rows(x2d, tuple(qs))
    return work[: x2d.shape[0] * _STATE_WORDS].view(-1, _STATE_WORDS)[:, _STATE_TOTAL]


def robust_quantiles(x2d: torch.Tensor,
                     qs: tuple = (25.0, 50.0, 75.0)) -> torch.Tensor:
    """Exact linear-interpolated percentiles along the last axis:
    (N, T) float32 → (N, len(qs)) float32, matching
    ``np.percentile(x2d, qs, axis=1, method='linear')`` under the
    NaN-beyond-infinity total order."""
    if x2d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"robust_quantiles runs on cuda or cpu, not {x2d.device}")
    return OP(x2d, [float(q) for q in qs])


OP_NAME = "meg_decoding_tpu_torch::robust_quantiles"


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cuda")
def OP(x2d: torch.Tensor, qs: list[float]) -> torch.Tensor:
    """The registered op behind ``robust_quantiles``: the kernel on CUDA."""
    return _launch(x2d, tuple(qs))


@OP.register_kernel("cpu")
def _op_cpu(x2d: torch.Tensor, qs: list[float]) -> torch.Tensor:
    _check(x2d, qs)
    return robust_quantiles_plain(x2d, tuple(qs))


@OP.register_fake
def _op_fake(x2d: torch.Tensor, qs: list[float]) -> torch.Tensor:
    _check(x2d, qs)
    return x2d.new_empty((x2d.shape[0], len(qs)))
