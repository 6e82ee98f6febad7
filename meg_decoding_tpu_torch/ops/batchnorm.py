"""Training-mode batch norm with a hand-written backward.  Port of the
``batch_norm_train`` custom VJP of ``meg_decoding_tpu/ops/pallas/batchnorm.py``
(``:183-239``).

Semantics are flax's fast variance (``var = E[x²] − E[x]²``, biased), with
f32 statistics and the affine output computed in f32 and rounded once to
x's dtype.  The statistics, and the whole backward, always come from
``ops/kernels/batchnorm.py``: the CUDA kernels on the card (``bn_stats`` in
the forward; ``bn_bwd``, one kernel for the sums and dx, in the backward),
their plain versions on the CPU; there is no backend switch.

Layout: x is NCW ``(B, C, T)``; the channel is dim 1 and M = B·T.

Synced BatchNorm (``mesh``, a ``core/mesh.py:DataMesh``): the statistics
are over the global batch, as JAX's mesh gets them from auto-spmd with XLA
BN (``cli/train_speech.py:295-300``).  The kernels stay and the reductions
are explicit: forward, ``bn_stats``'s (2, C) sums SUM all-reduced, then
mean, var and the affine; backward, ``bn_bwd_stats``'s sums alone SUM
all-reduced, then ``bn_bwd_dx``'s dx from the global sums with M the
global B·T (``_bn_bwd``, ``:210-237``).  The scale and bias gradients are
this rank's sums: the trainer SUM all-reduces every parameter gradient
once.  Under a mesh this route runs at every world size, 1 included.
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.ops.kernels.batchnorm import (
    bn_bwd,
    bn_bwd_dx,
    bn_bwd_stats,
    bn_stats,
)

__all__ = ["batch_norm_train"]


def _affine(x, scale, bias, s, ss, M, eps):
    mean = s / M
    var = ss / M - mean * mean
    invstd = torch.rsqrt(var + eps)
    a = scale * invstd
    b = bias - mean * a
    y = (x.to(torch.float32) * a[:, None] + b[:, None]).to(x.dtype)
    return y, mean, var, invstd


class _BatchNormTrain(torch.autograd.Function):
    """(y, mean, var) = BN(x; scale, bias); the backward is the JAX custom
    VJP's, including the exact contributions of the mean and var outputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        # a cotangent of an output nobody used arrives as None, and its
        # term of dx is skipped instead of added as a tensor of zeros
        ctx.set_materialize_grads(False)
        x = x.contiguous()
        s, ss = bn_stats(x)
        y, mean, var, invstd = _affine(x, scale, bias, s, ss,
                                       x.numel() // x.shape[1], eps)
        ctx.save_for_backward(x, scale, mean, invstd)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, invstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        dx, sg, sgx = bn_bwd(gy.contiguous(), x, scale, mean, invstd, gmean, gvar)
        return dx, sgx, sg, None


class _SyncedBatchNormTrain(torch.autograd.Function):
    """The same over every rank's batch: sums all-reduced before use.
    Each rank holds a batch of the same shape, so M is the local B·T times
    the world size."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, mesh):
        ctx.set_materialize_grads(False)
        x = x.contiguous()
        s, ss = bn_stats(x)
        sums = mesh.all_reduce_(torch.stack([s, ss]))
        M = x.numel() // x.shape[1] * mesh.world_size
        y, mean, var, invstd = _affine(x, scale, bias, sums[0], sums[1], M, eps)
        ctx.save_for_backward(x, scale, mean, invstd)
        ctx.mesh, ctx.M = mesh, M
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, invstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        gy = gy.contiguous()
        sg, sgx = bn_bwd_stats(gy, x, mean, invstd)
        # one all-reduce: the two sums and any mean / var cotangents (every
        # rank's cotangent of the global mean reaches every x)
        parts = [sg, sgx] + [t for t in (gmean, gvar) if t is not None]
        glob = ctx.mesh.all_reduce_(torch.stack(parts))
        rest = iter(glob[2:])
        gmean = None if gmean is None else next(rest)
        gvar = None if gvar is None else next(rest)
        dx = bn_bwd_dx(gy, x, scale, mean, invstd, glob[:2], ctx.M, gmean, gvar)
        return dx, sgx, sg, None, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float, mesh=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode batch norm of x (B, C, T) over dims 0 and 2.  Returns
    ``(y, mean, var)``: y in x's dtype, the batch mean and biased variance
    (C,) f32 for the caller's running-statistics update.  Gradients flow to
    x, scale and bias, and through mean and var when the caller uses them.
    With ``mesh`` the statistics are over every rank's batch (synced BN)."""
    if mesh is not None:
        return _SyncedBatchNormTrain.apply(x, scale, bias, float(eps), mesh)
    return _BatchNormTrain.apply(x, scale, bias, float(eps))
