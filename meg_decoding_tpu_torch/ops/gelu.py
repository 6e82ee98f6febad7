"""GELU implementations.  Port of ``meg_decoding_tpu/ops/gelu.py``.

* ``'erf'``  — exact GELU (``F.gelu``, the reference's default);
* ``'tanh'`` — the tanh approximation (an opt-in deviation in the JAX
  package's configs);
* ``'erf_poly'`` — GELU through the JAX package's exp-free
  piecewise-polynomial erf (≤ 2.5 f32 ulp of erf), with the same
  coefficients, so a config that selects it computes the same function.
  Its backward is the analytic GELU derivative Φ(x) + x·φ(x) (the JAX
  package's custom JVP), not autograd through the three polynomials.
  'erf' and 'tanh' keep PyTorch's own autograd.

  |u| ≤ 1          erf(u) = u · P₆(u²)
  1 < |u| ≤ 2.2    erf(u) = M₉(|u| − 1.6)       (mirrored by sign)
  2.2 < |u| ≤ 3.92 erf(u) = T₈(|u| − 3.06)
  |u| > 3.92       ±1
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["erf_poly", "gelu_erf_poly", "GeluErfPoly", "gelu", "resolve_impl"]


def resolve_impl(impl: str | None, approximate: bool) -> str:
    """Config plumbing: an explicit ``gelu_impl`` wins; otherwise the legacy
    ``gelu_approximate`` bool selects tanh vs exact erf."""
    if impl is not None:
        return impl
    return "tanh" if approximate else "erf"


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


def gelu_erf_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU via ``erf_poly``: 0.5·x·(1 + erf(x/√2)), f32 internal,
    one rounding back to the input dtype."""
    x32 = x.to(torch.float32)
    out = 0.5 * x32 * (1.0 + erf_poly(x32 * _SQRT_HALF))
    return out.to(x.dtype)


class GeluErfPoly(torch.autograd.Function):
    """``gelu_erf_poly`` with the analytic backward
    ``(Φ(x) + x·φ(x))·g`` in f32, rounded once to x's dtype
    (``ops/gelu.py:119-137`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_erf_poly(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        x32 = x.to(torch.float32)
        cdf = 0.5 * (1.0 + erf_poly(x32 * _SQRT_HALF))
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * x32 * x32)
        return ((cdf + x32 * pdf) * g.to(torch.float32)).to(x.dtype)


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU dispatcher: 'erf' | 'tanh' | 'erf_poly'."""
    if impl == "erf":
        return F.gelu(x)
    if impl == "tanh":
        return F.gelu(x, approximate="tanh")
    if impl == "erf_poly":
        return GeluErfPoly.apply(x)
    raise ValueError(f"unknown gelu impl {impl!r}")
