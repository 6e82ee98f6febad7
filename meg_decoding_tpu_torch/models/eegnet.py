"""EEGNet, EEGNetSub and LinearEncoder.  Port of
``meg_decoding_tpu/models/eegnet.py``.

Reference: ``meg_decoding/models.py`` — ``EEGNet`` (32-94),
``LinearEncoder`` (325-337).  The reference's ``EEGNetSub`` is broken and
unreachable (``models.py:96-98``); the JAX package's working variant, a
per-subject first conv, is ported as it is (``eegnet_sub_fixed``).

Layout: NCHW ``(B, F, C, T)``, PyTorch's convolution layout; the JAX
package runs NHWC ``(B, C, T, F)``.  The public call keeps the
reference's ``model(X, subject_idxs)`` with ``X: (B, C, T)``, and the
train step's ``centre=``/``generator=`` keywords (``centre`` is unused:
EEGNet has no spatial dropout).  Parameter names follow the flax tree
(``conv1``, ``bn1``, ``conv2``, ``bn2``, ``conv3_dw``, ``conv3_pw``,
``bn3``, ``classifier``; ``conv1_sub``; ``linear``), so
``interop.params_from_jax`` is a rename plus transpose.

The three BatchNorms are flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5)
over the feature axis; here each is a ``FusedBatchNorm`` over ``(B, F,
C·T)``, so in training mode the statistics and the backward run through
the ``bn_stats`` and ``bn_bwd`` kernels on the card.  (flax clamps the
fast variance at 0; the port does not: E[x²] − E[x]² < 0 needs a channel
constant to rounding.)

Dropout keeps each value with probability 1 − rate and scales the kept
ones by 1 / (1 − rate), as ``flax.linen.Dropout``.  The masks are drawn on
the host from a CPU ``torch.Generator`` (``EEGNet.draw_dropout``), so a
step draws the same masks on the card as on the CPU.  The train step
draws them before its device body and hands both in (``dropout_masks``,
on the device: a captured step copies nothing from the host,
``train/graph.py``); a forward given only the generator draws and copies
them itself.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from meg_decoding_tpu_torch.models.layers import FusedBatchNorm, _torch_uniform_

__all__ = ["EEGNet", "EEGNetSub", "LinearEncoder", "Dense"]


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), bias (out,), torch's default
    init range."""

    def __init__(self, in_features: int, out_features: int, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))
        with torch.no_grad():
            _torch_uniform_(self.weight, in_features, generator)
            _torch_uniform_(self.bias, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def _conv_weight(out_ch: int, in_per_group: int, kh: int, kw: int, device,
                 generator) -> nn.Parameter:
    w = torch.empty(out_ch, in_per_group, kh, kw, device=device)
    with torch.no_grad():
        _torch_uniform_(w, in_per_group * kh * kw, generator)
    return nn.Parameter(w)


def _same_pad(k: int) -> tuple[int, int]:
    """XLA's SAME padding of a stride-1 kernel of width k: (k − 1) // 2
    before, the rest after (an even k pads one more after)."""
    return (k - 1) // 2, k // 2


def _bn(num_features: int, device) -> FusedBatchNorm:
    return FusedBatchNorm(num_features, momentum=0.9, epsilon=1e-5,
                          device=device)


def _batch_norm(bn: FusedBatchNorm, h: torch.Tensor) -> torch.Tensor:
    """A BatchNorm over dim 1 of (B, F, H, W), as (B, F, H·W)."""
    return bn(h.reshape(h.shape[0], h.shape[1], -1)).reshape(h.shape)


def _dropout(h: torch.Tensor, rate: float,
             mask: torch.Tensor | None) -> torch.Tensor:
    """Dropout of h with the keep-mask ``mask`` (bool, h's shape, on h's
    device; None where ``rate`` keeps everything or nothing)."""
    if rate == 0.0:
        return h
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(h)
    return torch.where(mask, h / keep, torch.zeros_like(h))


def _draw_mask(shape: tuple, rate: float, generator: torch.Generator | None,
               mesh=None) -> torch.Tensor | None:
    """A keep-mask of ``shape`` on the host, drawn with ``generator`` (the
    same draws on every rank); under a data-parallel ``mesh`` the draw is
    the global batch's and this rank takes its rows of it.  None where the
    dropout needs no mask (rate 0 or 1)."""
    keep = 1.0 - rate
    if rate == 0.0 or keep == 0.0:
        return None
    if generator is None:
        raise ValueError("a training forward with dropout needs the masks "
                         "or a torch.Generator to draw them")
    if mesh is None:
        u = torch.rand(shape, generator=generator)
    else:
        b = shape[0]
        u = torch.rand((b * mesh.world_size, *shape[1:]),
                       generator=generator)[mesh.rank * b:(mesh.rank + 1) * b]
    return u < keep


class EEGNet(nn.Module):
    """Temporal conv → depthwise spatial conv → separable conv → Dense head
    (``eegnet.py:25-85``): conv1 (1, k1) SAME → F1 maps, BN; conv2
    depthwise over all C channels, groups F1, D·F1 maps, BN, ELU,
    AvgPool(1, p1), dropout; conv3 depthwise (1, k2) SAME + 1×1 → F2, BN,
    ELU, AvgPool(1, p2), dropout; flatten in flax's (T', F2) order → Dense
    to ``out_dim``."""

    def __init__(self, num_channels: int, T: int, F1: int = 16, D: int = 2,
                 F2: int = 32, k1: int = 30, k2: int = 4, p1: int = 2,
                 p2: int = 4, dr1: float = 0.5, dr2: float = 0.5,
                 out_dim: int = 512, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = None  # computes in f32, as the JAX module
        self.k1, self.k2, self.p1, self.p2 = k1, k2, p1, p2
        self.dr1, self.dr2 = dr1, dr2
        self.F1, self.D = F1, D
        self.mesh = None  # data-parallel mesh (models/layers.py:set_data_parallel)
        self.conv1 = _conv_weight(F1, 1, 1, k1, device, generator)
        self.bn1 = _bn(F1, device)
        self.conv2 = _conv_weight(D * F1, 1, num_channels, 1, device, generator)
        self.bn2 = _bn(D * F1, device)
        self.conv3_dw = _conv_weight(D * F1, 1, 1, k2, device, generator)
        self.conv3_pw = _conv_weight(F2, D * F1, 1, 1, device, generator)
        self.bn3 = _bn(F2, device)
        t_out = (T // p1) // p2
        self.classifier = Dense(F2 * t_out, out_dim, device=device,
                                generator=generator)

    def _conv1(self, x: torch.Tensor, subject_idxs) -> torch.Tensor:
        """(B, 1, C, T) → (B, F1, C, T)."""
        return F.conv2d(F.pad(x, _same_pad(self.k1)), self.conv1)

    def draw_dropout(self, generator: torch.Generator | None,
                     batch_size: int, T: int, centre=None) -> dict:
        """The randomness of a training forward on (batch_size, C, T),
        drawn on the host with ``generator`` in the forward's order: the
        forward's keyword arguments, ``{"dropout_masks": (m1, m2)}``, bool
        CPU masks of the shapes after each pool (None for a rate of 0).
        ``centre`` is ignored, as the forward ignores it."""
        t1 = T // self.p1
        shapes = ((batch_size, self.D * self.F1, 1, t1),
                  (batch_size, self.conv3_pw.shape[0], 1, t1 // self.p2))
        return {"dropout_masks": tuple(
            _draw_mask(shape, rate, generator, self.mesh)
            for shape, rate in zip(shapes, (self.dr1, self.dr2)))}

    def forward(self, X: torch.Tensor, subject_idxs=None,
                centre: int | None = None,
                generator: torch.Generator | None = None,
                dropout_masks: tuple | None = None) -> torch.Tensor:
        """X (B, C, T) → (B, out_dim).  In training mode the two dropout
        masks are ``dropout_masks`` (bool, of the shapes after each pool,
        on X's device) when given, else drawn with ``generator``
        (``draw_dropout``) and copied to the device."""
        train = self.training
        if train and dropout_masks is None:
            dropout_masks = tuple(
                None if m is None else m.to(X.device, non_blocking=True)
                for m in self.draw_dropout(generator, X.shape[0],
                                           X.shape[2])["dropout_masks"])
        m1, m2 = dropout_masks if dropout_masks is not None else (None, None)
        h = self._conv1(X[:, None], subject_idxs)
        h = _batch_norm(self.bn1, h)
        h = F.conv2d(h, self.conv2, groups=self.F1)       # (B, D·F1, 1, T)
        h = F.elu(_batch_norm(self.bn2, h))
        h = F.avg_pool2d(h, (1, self.p1))
        if train:
            h = _dropout(h, self.dr1, m1)
        h = F.conv2d(F.pad(h, _same_pad(self.k2)), self.conv3_dw,
                     groups=self.D * self.F1)
        h = F.conv2d(h, self.conv3_pw)                    # (B, F2, 1, T')
        h = F.elu(_batch_norm(self.bn3, h))
        h = F.avg_pool2d(h, (1, self.p2))
        if train:
            h = _dropout(h, self.dr2, m2)
        # flax flattens NHWC (B, 1, T', F2): T' major, F2 minor
        return self.classifier(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))


class EEGNetSub(EEGNet):
    """EEGNet with a per-subject first temporal conv: one bank
    ``conv1_sub`` (S, F1, 1, 1, k1), each sample convolved with its
    subject's (F1, 1, 1, k1) kernel (``eegnet.py:88-123``), as one grouped
    convolution over the batch."""

    def __init__(self, num_subjects: int, num_channels: int, T: int,
                 F1: int = 16, D: int = 2, F2: int = 32, k1: int = 30,
                 k2: int = 4, p1: int = 2, p2: int = 4, dr1: float = 0.5,
                 dr2: float = 0.5, out_dim: int = 512, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(num_channels, T, F1=F1, D=D, F2=F2, k1=k1, k2=k2,
                         p1=p1, p2=p2, dr1=dr1, dr2=dr2, out_dim=out_dim,
                         device=device, generator=generator)
        del self.conv1  # one kernel per subject instead
        bank = torch.empty(num_subjects, F1, 1, 1, k1, device=device)
        with torch.no_grad():
            _torch_uniform_(bank, k1, generator)  # U[±1/√k1], eegnet.py:107-110
        self.conv1_sub = nn.Parameter(bank)

    def _conv1(self, x: torch.Tensor, subject_idxs) -> torch.Tensor:
        if subject_idxs is None:
            raise ValueError("EEGNetSub needs subject indices")
        B, _, C, T = x.shape
        w = self.conv1_sub[subject_idxs.long()].reshape(B * self.F1, 1, 1,
                                                        self.k1)
        h = F.conv2d(F.pad(x.reshape(1, B, C, T), _same_pad(self.k1)), w,
                     groups=B)
        return h.reshape(B, self.F1, C, T)


class LinearEncoder(nn.Module):
    """Optional time mean (``scp``, reference ``models.py:334-335``), then
    one Dense named ``linear`` over the last axis (``eegnet.py:126-139``):
    (B, C) → (B, ``out_dim``) with ``scp``, else (B, C, T) → (B, C,
    ``out_dim``) as flax's Dense does."""

    def __init__(self, num_channels: int, out_dim: int = 512, scp: bool = True,
                 T: int | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = None
        self.scp = scp
        in_dim = num_channels if scp else int(T)
        self.linear = Dense(in_dim, out_dim, device=device, generator=generator)

    def forward(self, X: torch.Tensor, subject_idxs=None,
                centre: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.scp:
            X = X.mean(dim=-1)  # (B, C, T) → (B, C)
        return self.linear(X)
