"""The erf_poly GELU, forward and analytic backward: the CUDA kernels
``csrc/gelu_erf_poly.cu`` and their plain PyTorch versions.

``erf_poly`` is the JAX package's exp-free piecewise-polynomial erf
(``meg_decoding_tpu/ops/gelu.py:70-105``, ≤ 2.5 f32 ulp of erf), with the
same coefficients, so a config that selects ``gelu_impl: erf_poly``
computes the same function on both sides:

  |u| ≤ 1          erf(u) = u · P₆(u²)
  1 < |u| ≤ 2.2    erf(u) = M₉(|u| − 1.6)       (mirrored by sign)
  2.2 < |u| ≤ 3.92 erf(u) = T₈(|u| − 3.06)
  |u| > 3.92       ±1

``gelu_fwd`` is 0.5·x·(1 + erf_poly(x/√2)) and ``gelu_bwd`` the analytic
derivative (Φ(x) + x·φ(x))·g of the JAX package's custom JVP (``:119-137``),
each in f32 and rounded once to x's dtype.

These kernels replace no Pallas kernel: in the JAX package the chain is
plain ``jnp``, which XLA fuses into one elementwise op each way.  The plain
versions here are the same chain as eager PyTorch ops, each of which reads
and writes the whole activation.

``gelu_fwd`` and ``gelu_bwd`` launch their kernel for a CUDA tensor and run
the plain version only for a CPU tensor.  They take float32 or bfloat16 of
any shape; on the card the tensors must be contiguous (taken as flat).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["erf_poly", "gelu_fwd", "gelu_fwd_plain", "gelu_bwd",
           "gelu_bwd_plain", "launches", "reset_launches"]

_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches since the last reset_launches(), per kernel (a replay of a
# captured train step adds what its capture counted, train/graph.py)
launches = {"gelu_fwd": 0, "gelu_bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327
_UMAX = 3.92
_B1 = 2.2
_C1 = 1.6   # mid-interval Horner center, (1 + 2.2)/2
_C2 = 3.06  # tail-interval Horner center, (2.2 + 3.92)/2

# erf(u)/u over u² ∈ [0, 1] (increasing powers of u²)
_P = (
    1.1283791642036094, -0.3761262253264794, 0.11283567972615145,
    -0.026853537766035242, 0.005188380744448103, -0.0008014557174955704,
    7.87898134825695e-05,
)
# erf(u) over u ∈ [1, 2.2] (increasing powers of u − 1.6)
_M = (
    0.9763483813576088, 0.08722905144327303, -0.13956618665278978,
    0.1197950067239394, -0.049321021018725146, -0.004384953262741153,
    0.015549647872260673, -0.005987836463361508, -0.0011343875580184023,
    0.0013519651430629316,
)
# erf(u) over u ∈ [2.2, 3.92] (increasing powers of u − 3.06)
_T = (
    0.9999849227209708, 9.675459819190899e-05, -0.00029653724335458495,
    0.0005731544734380906, -0.0007728300529582685, 0.0007715595580880792,
    -0.00060149821458484, 0.00034682825182840094, -0.00010350064171581603,
)


def _horner(coef, x: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x, coef[-1])
    for c in coef[-2::-1]:
        acc = acc * x + c
    return acc


def erf_poly(u: torch.Tensor) -> torch.Tensor:
    """Exp-free piecewise-polynomial erf, ≤2.5 f32 ulp of the true value on
    the whole line.  Computes in f32; returns f32 (callers round once)."""
    u32 = u.to(torch.float32)
    au = u32.abs()
    inner = au * _horner(_P, au * au)
    mid = _horner(_M, au - _C1)
    tail = _horner(_T, au - _C2)
    mag = torch.where(au <= 1.0, inner, torch.where(au <= _B1, mid, tail))
    mag = torch.where(au > _UMAX, torch.ones_like(mag), mag)
    return torch.sign(u32) * mag


def gelu_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU via ``erf_poly``: 0.5·x·(1 + erf(x/√2)), f32 internal,
    one rounding back to the input dtype."""
    x32 = x.to(torch.float32)
    out = 0.5 * x32 * (1.0 + erf_poly(x32 * _SQRT_HALF))
    return out.to(x.dtype)


def gelu_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(Φ(x) + x·φ(x))·g in f32, rounded once to x's dtype."""
    x32 = x.to(torch.float32)
    cdf = 0.5 * (1.0 + erf_poly(x32 * _SQRT_HALF))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x32 * x32)
    return ((cdf + x32 * pdf) * g.to(torch.float32)).to(x.dtype)


_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# kernel → its launcher in the library and the launcher's arguments
_LAUNCHERS = {
    "gelu_fwd": ("gelu_erf_poly_fwd_launch", [_PTR] * 2 + [_I64, _INT, _PTR]),
    "gelu_bwd": ("gelu_erf_poly_bwd_launch", [_PTR] * 3 + [_I64, _INT, _PTR]),
}
_FNS: dict = {}


def _fn(kernel: str):
    fn = _FNS.get(kernel)
    if fn is None:
        from meg_decoding_tpu_torch.ops.kernels.build import load_library

        name, argtypes = _LAUNCHERS[kernel]
        fn = getattr(load_library("gelu_erf_poly"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FNS[kernel] = fn
    return fn


def _check(name: str, *xs: torch.Tensor) -> bool:
    """Validates inputs of one shape, dtype and device; True when they lie
    on the CPU (the plain version's case)."""
    x = xs[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    dev = x.device
    for other in xs[1:]:
        if (other.shape, other.dtype, other.device) != (x.shape, x.dtype, dev):
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in xs:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return False


def _launch(kernel: str, *xs: torch.Tensor) -> torch.Tensor:
    """Launches ``kernel`` on the CUDA tensors xs (x first) into a new
    tensor like x on the current stream; an empty x launches nothing."""
    x = xs[0]
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _fn(kernel)(*(t.data_ptr() for t in xs), out.data_ptr(), x.numel(),
                      int(x.dtype == torch.bfloat16),
                      torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    launches[kernel] += 1
    return out


def gelu_fwd(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·(1 + erf_poly(x/√2)) of x (f32/bf16) in x's dtype."""
    if _check("gelu_fwd", x):
        return gelu_fwd_plain(x)
    return _launch("gelu_fwd", x)


def gelu_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(Φ(x) + x·φ(x))·g for x and g of one shape and dtype (f32/bf16), in
    x's dtype."""
    if _check("gelu_bwd", x, g):
        return gelu_bwd_plain(x, g)
    return _launch("gelu_bwd", x, g)
