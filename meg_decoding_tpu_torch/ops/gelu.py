"""GELU implementations.  Port of ``meg_decoding_tpu/ops/gelu.py``.

* ``'erf'``  — exact GELU (``F.gelu``, the reference's default);
* ``'tanh'`` — the tanh approximation (an opt-in deviation in the JAX
  package's configs);
* ``'erf_poly'`` — GELU through the JAX package's exp-free
  piecewise-polynomial erf (≤ 2.5 f32 ulp of erf), with the same
  coefficients, so a config that selects it computes the same function.
  Its backward is the analytic GELU derivative Φ(x) + x·φ(x) (the JAX
  package's custom JVP), not autograd through the three polynomials.
  Both directions come from ``ops/kernels/gelu.py``: one CUDA kernel each
  on the card, the plain op chain on the CPU.
  'erf' and 'tanh' keep PyTorch's own autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from meg_decoding_tpu_torch.ops.kernels.gelu import gelu_bwd, gelu_fwd
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = ["GeluErfPoly", "gelu", "resolve_impl"]


def resolve_impl(impl: str | None, approximate: bool) -> str:
    """Config plumbing: an explicit ``gelu_impl`` wins; otherwise the legacy
    ``gelu_approximate`` bool selects tanh vs exact erf."""
    if impl is not None:
        return impl
    return "tanh" if approximate else "erf"


class GeluErfPoly(torch.autograd.Function):
    """The erf_poly GELU with the analytic backward
    ``(Φ(x) + x·φ(x))·g`` in f32, rounded once to x's dtype
    (``ops/gelu.py:119-137`` of the JAX package)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        with scope("gelu"):
            return gelu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with scope("gelu"):
            # the gradient arriving from the next op may be a strided view
            # (a mean's expand, a permute); the kernel takes flat tensors
            return gelu_bwd(x, g.contiguous())


def gelu(x: torch.Tensor, impl: str = "erf") -> torch.Tensor:
    """GELU dispatcher: 'erf' | 'tanh' | 'erf_poly'; the scope ``gelu``
    of a captured body (``utils/profiling.py``).  The backward of 'erf'
    and 'tanh' is autograd's, in the scope open where it runs."""
    with scope("gelu"):
        if impl == "erf":
            return F.gelu(x)
        if impl == "tanh":
            return F.gelu(x, approximate="tanh")
        if impl == "erf_poly":
            return GeluErfPoly.apply(x)
    raise ValueError(f"unknown gelu impl {impl!r}")
