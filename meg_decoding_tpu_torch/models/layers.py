"""Core encoder layers.  Port of ``meg_decoding_tpu/models/layers.py``.

Reference semantics: ``meg_decoding/models.py`` — ``SpatialAttention``
(167-220), ``SpatialDropout`` (223-241), ``SubjectBlock`` (244-273),
``ConvBlock`` (276-322).

Layout: the JAX package runs time-major ``(B, T, C)`` inside the encoder;
here activations are NCW ``(B, C, T)``, PyTorch's convolution layout, and
the public functions keep the reference's ``(B, C, T)``.  Parameter names
follow the flax tree (``z_re``/``z_im``, ``weight``, ``conv0``…``conv2b``,
``bn0``/``bn1`` with ``scale``/``bias`` and buffers ``mean``/``var``) so
``interop.params_from_jax`` is a rename plus transpose.

Training mode (``module.train()``): spatial dropout with one centre per
batch, and BatchNorm on batch statistics through ``ops/batchnorm.py``.
A training forward does not write the BN running statistics: each
``FusedBatchNorm`` keeps its update as a proposal, and the train step
commits every proposal only where the step was finite
(``commit_running_stats``), as the JAX step keeps the old ``batch_stats``
of a skipped step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from meg_decoding_tpu_torch.ops.batchnorm import batch_norm_train
from meg_decoding_tpu_torch.ops.gelu import gelu

__all__ = [
    "fourier_basis",
    "spatial_attention_weights",
    "spatial_dropout_mask",
    "SpatialAttention",
    "SubjectLayers",
    "FusedBatchNorm",
    "commit_running_stats",
    "Conv1x1",
    "Conv1d",
    "ConvBlock",
]


def fourier_basis(loc: np.ndarray, K: int) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of the 2-D Fourier basis at sensor positions, kl-major
    like the reference (``models.py:173-195``): ``phi[kl, c] = 2π (k·x_c +
    l·y_c)``; returns ``cos(phi), sin(phi)`` of shape ``(K², C)``."""
    loc = np.asarray(loc, dtype=np.float32)
    x, y = loc[:, 0], loc[:, 1]
    k = np.repeat(np.arange(K, dtype=np.float32), K)
    l = np.tile(np.arange(K, dtype=np.float32), K)
    phi = 2.0 * np.pi * (np.outer(k, x) + np.outer(l, y))  # (K², C)
    return np.cos(phi).astype(np.float32), np.sin(phi).astype(np.float32)


def spatial_attention_weights(z_re, z_im, cos, sin) -> torch.Tensor:
    """softmax over channels of ``Re(z)·cos + Im(z)·sin`` (models.py:204-213)."""
    return torch.softmax(z_re @ cos + z_im @ sin, dim=-1)  # (D1, C)


def spatial_dropout_mask(loc: torch.Tensor, d_drop: float,
                         centre: int) -> torch.Tensor:
    """Zero the channels within ``d_drop`` (strictly) of sensor ``centre``,
    one centre for the whole batch (reference ``models.py:232-241``).
    loc (C, 2) → (C,) mask of 0.0/1.0."""
    diff = loc - loc[centre]
    distances = torch.sqrt((diff * diff).sum(dim=-1))
    return torch.where(distances < d_drop, 0.0, 1.0).to(loc.dtype)


class SpatialAttention(nn.Module):
    """Fourier-parameterized spatial attention: (B, C, T) → (B, D1, T).

    ``z_re``/``z_im`` are the real/imaginary parts of the reference's complex
    ``z ∈ C^{D1×K²}``, initialized U[0, 1) like ``torch.rand(cfloat)``.
    In training mode the input channels near one random sensor are dropped
    (``spatial_dropout_mask``) before the attention."""

    def __init__(self, loc: np.ndarray, D1: int = 270, K: int = 32,
                 d_drop: float = 0.1, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.d_drop = d_drop
        cos_t, sin_t = fourier_basis(loc, K)
        self.register_buffer("cos", torch.tensor(cos_t, device=device),
                             persistent=False)
        self.register_buffer("sin", torch.tensor(sin_t, device=device),
                             persistent=False)
        self.register_buffer("loc", torch.tensor(np.asarray(loc, np.float32),
                                                 device=device),
                             persistent=False)
        self.z_re = nn.Parameter(torch.empty(D1, K * K, device=device))
        self.z_im = nn.Parameter(torch.empty(D1, K * K, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        self.z_re.uniform_(0.0, 1.0, generator=generator)
        self.z_im.uniform_(0.0, 1.0, generator=generator)

    def forward(self, X: torch.Tensor, centre: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """In training mode the dropout centre is ``centre`` when given, else
        drawn uniformly from the sensors with ``generator`` (a CPU
        ``torch.Generator``, so the draw needs no device sync)."""
        sa = spatial_attention_weights(self.z_re, self.z_im, self.cos, self.sin)
        if self.training:
            if centre is None:
                if generator is None:
                    raise ValueError("a training forward needs a dropout "
                                     "centre or a torch.Generator to draw it")
                centre = int(torch.randint(self.loc.shape[0], (),
                                           generator=generator))
            mask = spatial_dropout_mask(self.loc, self.d_drop, centre)
            X = X * mask[None, :, None]
        return torch.matmul(sa, X)  # (D1, C) @ (B, C, T)


class SubjectLayers(nn.Module):
    """Per-subject 1×1 channel mix as one gathered ``bmm``: weight
    (S, D_in, D_out) like flax, no bias (``models.py:255-263``)."""

    def __init__(self, num_subjects: int, dim: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_subjects, dim, dim,
                                               device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _torch_uniform_(self.weight, self.weight.shape[1], generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
        Wb = self.weight[subject_idxs.long()]  # (B, D_in, D_out)
        # f32 like the JAX einsum, which promotes a bf16 X to the f32 weight
        return torch.bmm(Wb.transpose(1, 2), X.to(Wb.dtype))


class FusedBatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C, T) with running statistics.

    Eval mode: the affine is written out as the JAX package computes it
    (``layers.py:190-194``): ``a = scale·rsqrt(var + eps)``,
    ``b = bias − mean·a``, ``y = x·a + b`` in f32, rounded once to the
    output dtype (``F.batch_norm`` rounds differently).

    Training mode: batch statistics through ``batch_norm_train`` (biased
    variance, which ``nn.BatchNorm1d`` would not store), and the running
    update ``m·ra + (1 − m)·batch`` kept in ``proposed`` until
    ``commit_running_stats`` writes it."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype | None = None,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("mean", torch.zeros(num_features, device=device))
        self.register_buffer("var", torch.ones(num_features, device=device))
        # (mean, var) running statistics of the last training forward, not
        # yet committed
        self.proposed: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = batch_norm_train(x, self.scale, self.bias,
                                            self.epsilon)
            m = self.momentum
            with torch.no_grad():
                self.proposed = (m * self.mean + (1.0 - m) * mean,
                                 m * self.var + (1.0 - m) * var)
            return y.to(self.dtype or x.dtype)
        a = self.scale * torch.rsqrt(self.var + self.epsilon)
        b = self.bias - self.mean * a
        y = x.to(torch.float32) * a[:, None] + b[:, None]
        return y.to(self.dtype or x.dtype)


@torch.no_grad()
def commit_running_stats(model: nn.Module, ok: torch.Tensor) -> None:
    """Write the proposed running statistics of every ``FusedBatchNorm`` in
    ``model`` where ``ok`` (a 0-dim bool tensor) holds and keep the old ones
    where it does not — on the device, without a sync — then clear the
    proposals, so none can be committed twice or by a later step."""
    for mod in model.modules():
        if isinstance(mod, FusedBatchNorm) and mod.proposed is not None:
            new_mean, new_var = mod.proposed
            mod.mean.copy_(torch.where(ok, new_mean, mod.mean))
            mod.var.copy_(torch.where(ok, new_var, mod.var))
            mod.proposed = None


def _torch_uniform_(t: torch.Tensor, fan_in: int,
                    generator: torch.Generator | None) -> torch.Tensor:
    """torch Conv/Linear default init range U[−1/√fan_in, 1/√fan_in] (the
    JAX package's ``torch_kernel_init``/``torch_bias_init``; in every layer
    the bias's fan-in is the weight's)."""
    bound = 1.0 / np.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


class Conv1x1(nn.Module):
    """flax ``nn.Dense`` over the channel axis of (B, C, T): weight
    (out, in), bias (out,)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _torch_uniform_(self.weight, self.weight.shape[1], generator)
        _torch_uniform_(self.bias, self.weight.shape[1], generator)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or X.dtype
        return (torch.matmul(self.weight.to(dt), X.to(dt))
                + self.bias.to(dt)[:, None])


class Conv1d(nn.Module):
    """flax ``nn.Conv`` with SAME padding on (B, C, T): weight
    (out, in, ks), bias (out,)."""

    def __init__(self, in_features: int, out_features: int, ks: int,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, ks,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        fan_in = self.weight.shape[1] * self.weight.shape[2]
        _torch_uniform_(self.weight, fan_in, generator)
        _torch_uniform_(self.bias, fan_in, generator)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or X.dtype
        return F.conv1d(X.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding="same")


class ConvBlock(nn.Module):
    """Residual conv block: conv(+skip) → BN → GELU, conv(+residual) → BN →
    GELU, then GLU over two D2-wide convs ``conv2a``/``conv2b``
    (``layers.py:208-267``; reference ``models.py:276-322``)."""

    def __init__(self, k: int, in_dim: int, D2: int, ks: int = 3,
                 dtype: torch.dtype | None = None, gelu_impl: str = "erf",
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.gelu_impl = gelu_impl
        conv = lambda cin: Conv1d(cin, D2, ks, dtype, device, generator)
        # flax momentum 0.9 = 1 − torch momentum 0.1 (layers.py:221)
        bn = lambda: FusedBatchNorm(D2, momentum=0.9, dtype=dtype,
                                    device=device)
        self.conv0 = conv(in_dim)
        self.bn0 = bn()
        self.conv1 = conv(D2)
        self.bn1 = bn()
        self.conv2a = conv(D2)
        self.conv2b = conv(D2)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = self.conv0(X)
        if self.k > 0:
            h = h + X  # skip only when in/out dims match (models.py:308-312)
        h = gelu(self.bn0(h), self.gelu_impl)
        h2 = self.conv1(h) + h
        h2 = gelu(self.bn1(h2), self.gelu_impl)
        return self.conv2a(h2) * torch.sigmoid(self.conv2b(h2))
