"""Core encoder layers.  Port of ``meg_decoding_tpu/models/layers.py``.

Reference semantics: ``meg_decoding/models.py`` — ``SpatialAttention``
(167-220), ``SpatialDropout`` (223-241), ``SubjectBlock`` (244-273),
``ConvBlock`` (276-322).

Layout: the public functions keep the reference's ``(B, C, T)``.  Inside
the conv stack the layout follows the compute dtype (``time_major``): in
bf16 (and f16) activations are time-major ``(B, T, C)``, as in the JAX
package, because cuDNN's half-precision engines on Hopper are NHWC: each
``Conv1d`` hands cuDNN the view ``X.transpose(1, 2).unsqueeze(2)``, a
channels-last (B, C, 1, T) tensor it reads in place, and its output comes
back channels-last, which is ``(B, T, C)`` again by a view.  In f32, cuDNN's engines are NCHW, so
activations stay NCW ``(B, C, T)``.  The BatchNorm kernels take either
layout as it lies (``ops/batchnorm.py``).  Parameter names follow the flax
tree (``z_re``/``z_im``, ``weight``, ``conv0``…``conv2b``, ``bn0``/``bn1``
with ``scale``/``bias`` and buffers ``mean``/``var``) so
``interop.params_from_jax`` is a rename plus transpose; the layout changes
no parameter.

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
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = [
    "fourier_basis",
    "spatial_attention_weights",
    "spatial_dropout_mask",
    "SpatialAttention",
    "SubjectLayers",
    "FusedBatchNorm",
    "commit_running_stats",
    "set_data_parallel",
    "time_major",
    "Conv1x1",
    "Conv1d",
    "ConvBlock",
]


def time_major(dtype: torch.dtype | None) -> bool:
    """Whether a conv stack computing in ``dtype`` holds its activations
    time-major ``(B, T, C)``: bf16 and f16, whose cuDNN engines on Hopper
    are NHWC; f32 (or None, the input's f32) keeps NCW, where cuDNN's
    engines are NCHW."""
    return dtype in (torch.bfloat16, torch.float16)


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
                         centre: int | torch.Tensor) -> torch.Tensor:
    """Zero the channels within ``d_drop`` (strictly) of sensor ``centre``,
    one centre for the whole batch (reference ``models.py:232-241``).
    loc (C, 2) → (C,) mask of 0.0/1.0.  ``centre`` is an int or a 0-dim
    integer tensor on loc's device, read on the device (``index_select``:
    indexing with a 0-dim tensor would read it back to the host)."""
    centre = torch.as_tensor(centre, dtype=torch.int64, device=loc.device)
    diff = loc - loc.index_select(0, centre.reshape(1))
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

    def draw_centre(self, generator: torch.Generator | None) -> torch.Tensor:
        """The dropout centre of a training forward, drawn uniformly from
        the sensors with ``generator`` (a CPU ``torch.Generator``, so the
        draw needs no device sync): a 0-dim int64 CPU tensor."""
        if generator is None:
            raise ValueError("a training forward needs a dropout centre or "
                             "a torch.Generator to draw it")
        return torch.randint(self.loc.shape[0], (), generator=generator)

    def forward(self, X: torch.Tensor,
                centre: int | torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """In training mode the dropout centre is ``centre`` when given (an
        int, or a 0-dim int64 tensor on the device: what a captured step
        takes, ``train/graph.py``), else drawn with ``generator``
        (``draw_centre``)."""
        sa = spatial_attention_weights(self.z_re, self.z_im, self.cos, self.sin)
        if self.training:
            if centre is None:
                centre = int(self.draw_centre(generator))
            mask = spatial_dropout_mask(self.loc, self.d_drop, centre)
            X = X * mask[None, :, None]
        return torch.matmul(sa, X)  # (D1, C) @ (B, C, T)


class SubjectLayers(nn.Module):
    """Per-subject 1×1 channel mix as one gathered ``bmm``: weight
    (S, D_in, D_out) like flax, no bias (``models.py:255-263``).  Takes
    (B, D_in, T); writes (B, D_out, T), or with ``time_major`` (B, T,
    D_out) directly (the product the other way round, no copy)."""

    def __init__(self, num_subjects: int, dim: int, device=None,
                 generator: torch.Generator | None = None,
                 time_major: bool = False):
        super().__init__()
        self.time_major = time_major
        self.weight = nn.Parameter(torch.empty(num_subjects, dim, dim,
                                               device=device))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None):
        _torch_uniform_(self.weight, self.weight.shape[1], generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor) -> torch.Tensor:
        Wb = self.weight[subject_idxs.long()]  # (B, D_in, D_out)
        # f32 like the JAX einsum, which promotes a bf16 X to the f32 weight
        if self.time_major:
            return torch.bmm(X.to(Wb.dtype).transpose(1, 2), Wb)
        return torch.bmm(Wb.transpose(1, 2), X.to(Wb.dtype))


class FusedBatchNorm(nn.Module):
    """BatchNorm over dim 1 of (B, C, T), or with ``time_major`` over the
    last dim of (B, T, C), with running statistics.

    Eval mode: the affine is written out as the JAX package computes it
    (``layers.py:190-194``): ``a = scale·rsqrt(var + eps)``,
    ``b = bias − mean·a``, ``y = x·a + b`` in f32, rounded once to the
    output dtype (``F.batch_norm`` rounds differently).

    Training mode: batch statistics through ``batch_norm_train`` (biased
    variance, which ``nn.BatchNorm1d`` would not store), and the running
    update ``m·ra + (1 − m)·batch`` kept in ``proposed`` until
    ``commit_running_stats`` writes it.  With ``mesh`` set
    (``set_data_parallel``, as ``SyncBatchNorm`` holds a process group) the
    statistics are over every rank's batch."""

    def __init__(self, num_features: int, momentum: float = 0.99,
                 epsilon: float = 1e-5, dtype: torch.dtype | None = None,
                 device=None, time_major: bool = False):
        super().__init__()
        self.time_major = time_major
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
        self.mesh = None  # a core/mesh.py DataMesh: synced statistics

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the scope "batchnorm" of a captured body (utils/profiling.py):
        # the statistics, the affine and the proposed running statistics
        with scope("batchnorm"):
            if self.training:
                y, mean, var = batch_norm_train(x, self.scale, self.bias,
                                                self.epsilon, self.mesh,
                                                self.time_major)
                m = self.momentum
                with torch.no_grad():
                    self.proposed = (m * self.mean + (1.0 - m) * mean,
                                     m * self.var + (1.0 - m) * var)
                return y.to(self.dtype or x.dtype)
            a = self.scale * torch.rsqrt(self.var + self.epsilon)
            b = self.bias - self.mean * a
            if not self.time_major:
                a, b = a[:, None], b[:, None]
            y = x.to(torch.float32) * a + b
            return y.to(self.dtype or x.dtype)


@torch.no_grad()
def commit_running_stats(model: nn.Module, ok: torch.Tensor) -> None:
    """Write the proposed running statistics of every ``FusedBatchNorm`` in
    ``model`` where ``ok`` (a 0-dim bool tensor) holds and keep the old ones
    where it does not — on the device, without a sync — then clear the
    proposals, so none can be committed twice or by a later step.  The
    scope ``bn_commit`` of a captured body (``utils/profiling.py``)."""
    with scope("bn_commit"):
        for mod in model.modules():
            if isinstance(mod, FusedBatchNorm) and mod.proposed is not None:
                new_mean, new_var = mod.proposed
                mod.mean.copy_(torch.where(ok, new_mean, mod.mean))
                mod.var.copy_(torch.where(ok, new_var, mod.var))
                mod.proposed = None


def set_data_parallel(model: nn.Module, mesh) -> nn.Module:
    """Give the data-parallel mesh (None: one device again) to every
    submodule of ``model`` that takes one: each ``FusedBatchNorm`` (synced
    statistics) and EEGNet (dropout masks drawn over the global batch).
    Returns the model."""
    for mod in model.modules():
        if hasattr(mod, "mesh"):
            mod.mesh = mesh
    return model


def _torch_uniform_(t: torch.Tensor, fan_in: int,
                    generator: torch.Generator | None) -> torch.Tensor:
    """torch Conv/Linear default init range U[−1/√fan_in, 1/√fan_in] (the
    JAX package's ``torch_kernel_init``/``torch_bias_init``; in every layer
    the bias's fan-in is the weight's)."""
    bound = 1.0 / np.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)


class Conv1x1(nn.Module):
    """flax ``nn.Dense`` over the channel axis of (B, C, T), or with
    ``time_major`` of (B, T, C): weight (out, in), bias (out,)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None,
                 time_major: bool = False):
        super().__init__()
        self.dtype = dtype
        self.time_major = time_major
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
        if self.time_major:
            return (torch.matmul(X.to(dt), self.weight.to(dt).t())
                    + self.bias.to(dt))
        return (torch.matmul(self.weight.to(dt), X.to(dt))
                + self.bias.to(dt)[:, None])


class _KrscWeight(torch.autograd.Function):
    """A time-major ``Conv1d``'s weight (out, in, ks) cast to ``dt`` in the
    KRSC order (out, ks, in) that cuDNN's NHWC engine takes, as an (out,
    in, ks) view.  Its gradient comes back in the parameter's dtype and in
    the parameter's contiguous layout, as every other parameter's does, so
    Adam's multi-tensor kernel takes it (``ops/kernels/adam.py``);
    autograd's own cast would keep the KRSC strides.  One cast each way."""

    @staticmethod
    def forward(ctx, weight, dt):
        ctx.dtype = weight.dtype
        return weight.transpose(1, 2).to(
            dt, memory_format=torch.contiguous_format).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=torch.contiguous_format), None


class Conv1d(nn.Module):
    """flax ``nn.Conv`` with SAME padding on (B, C, T), or with
    ``time_major`` on (B, T, C): weight (out, in, ks), bias (out,)."""

    def __init__(self, in_features: int, out_features: int, ks: int,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None,
                 time_major: bool = False):
        super().__init__()
        self.dtype = dtype
        self.time_major = time_major
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
        if self.time_major:
            # (B, T, C) as the channels-last (B, C, 1, T) that cuDNN's NHWC
            # engine reads in place, and the weight cast straight into the
            # KRSC order (out, 1, ks, in) that engine takes, so that nothing
            # is reordered; the channels-last output is (B, T, C) again by a
            # view.  conv2d, because conv1d copies a 3-D input contiguous
            # (NCW) before it looks at the layout.
            w = _KrscWeight.apply(self.weight, dt)
            y = F.conv2d(X.to(dt).transpose(1, 2).unsqueeze(2), w.unsqueeze(2),
                         self.bias.to(dt), padding="same")
            return y.squeeze(2).transpose(1, 2)
        return F.conv1d(X.to(dt), self.weight.to(dt), self.bias.to(dt),
                        padding="same")


class ConvBlock(nn.Module):
    """Residual conv block: conv(+skip) → BN → GELU, conv(+residual) → BN →
    GELU, then GLU over two D2-wide convs ``conv2a``/``conv2b``
    (``layers.py:208-267``; reference ``models.py:276-322``).  Takes and
    returns (B, C, T), or (B, T, C) where ``time_major(dtype)``."""

    def __init__(self, k: int, in_dim: int, D2: int, ks: int = 3,
                 dtype: torch.dtype | None = None, gelu_impl: str = "erf",
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.k = k
        self.gelu_impl = gelu_impl
        tm = time_major(dtype)
        conv = lambda cin: Conv1d(cin, D2, ks, dtype, device, generator, tm)
        # flax momentum 0.9 = 1 − torch momentum 0.1 (layers.py:221)
        bn = lambda: FusedBatchNorm(D2, momentum=0.9, dtype=dtype,
                                    device=device, time_major=tm)
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
