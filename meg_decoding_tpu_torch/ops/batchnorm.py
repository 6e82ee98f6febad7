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
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.ops.kernels.batchnorm import bn_bwd, bn_stats

__all__ = ["batch_norm_train"]


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
        M = x.numel() // x.shape[1]
        mean = s / M
        var = ss / M - mean * mean
        invstd = torch.rsqrt(var + eps)
        a = scale * invstd
        b = bias - mean * a
        y = (x.to(torch.float32) * a[:, None] + b[:, None]).to(x.dtype)
        ctx.save_for_backward(x, scale, mean, invstd)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, scale, mean, invstd = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros_like(x)
        dx, sg, sgx = bn_bwd(gy.contiguous(), x, scale, mean, invstd, gmean, gvar)
        return dx, sgx, sg, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode batch norm of x (B, C, T) over dims 0 and 2.  Returns
    ``(y, mean, var)``: y in x's dtype, the batch mean and biased variance
    (C,) f32 for the caller's running-statistics update.  Gradients flow to
    x, scale and bias, and through mean and var when the caller uses them."""
    return _BatchNormTrain.apply(x, scale, bias, float(eps))
