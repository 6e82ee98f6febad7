"""The brain encoder in plain PyTorch, on a dict of weights.

SpatialAttention (Fourier-parameterised softmax over sensors, spatial
dropout of the sensors within ``d_drop`` of one centre in training) →
1×1 conv → per-subject 1×1 mix → ``num_blocks`` ConvBlocks (conv(+skip)
→ BN → GELU, conv(+residual) → BN → GELU, GLU over two convs) → two 1×1
convs with GELU; seq2seq keeps (B, F, T), else the time mean (B, F).
BatchNorm in training uses the batch's mean and biased variance, and
moves its running statistics by 0.1 of the way; in eval it uses them.
GELU is the exact erf form.

``q`` rounds the operands of every convolution and matrix product: the
identity at f32, or a lower precision for a control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["param_spec", "buffer_spec", "fourier_basis", "forward",
           "BN_EPS", "BN_MOMENTUM"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # running ← 0.9·running + 0.1·batch
_SQRT_HALF = 1.0 / math.sqrt(2.0)


def param_spec(C: int, num_subjects: int, D1: int, D2: int, F_out: int,
               K: int, num_blocks: int = 5) -> list:
    """``[(name, shape, init)]`` of every trained weight; ``init`` is
    ``("uniform", lo, hi)`` (PyTorch's default ranges for a convolution
    or a linear map: ±1/√fan_in) or ``("const", value)``."""
    def fan(n):
        b = 1.0 / math.sqrt(n)
        return ("uniform", -b, b)

    spec = [("subject_block.spatial_attention.z_re", (D1, K * K),
             ("uniform", 0.0, 1.0)),
            ("subject_block.spatial_attention.z_im", (D1, K * K),
             ("uniform", 0.0, 1.0)),
            ("subject_block.conv.weight", (D1, D1), fan(D1)),
            ("subject_block.conv.bias", (D1,), fan(D1)),
            ("subject_block.subject_layer.weight", (num_subjects, D1, D1),
             fan(D1))]
    for k in range(num_blocks):
        cin = D1 if k == 0 else D2
        pre = f"conv{k}."
        for conv, ci in (("conv0", cin), ("conv1", D2), ("conv2a", D2),
                         ("conv2b", D2)):
            spec += [(pre + conv + ".weight", (D2, ci, 3), fan(ci * 3)),
                     (pre + conv + ".bias", (D2,), fan(ci * 3))]
            if conv in ("conv0", "conv1"):
                bn = pre + ("bn0" if conv == "conv0" else "bn1")
                spec += [(bn + ".scale", (D2,), ("const", 1.0)),
                         (bn + ".bias", (D2,), ("const", 0.0))]
    spec += [("conv_final1.weight", (2 * D2, D2), fan(D2)),
             ("conv_final1.bias", (2 * D2,), fan(D2)),
             ("conv_final2.weight", (F_out, 2 * D2), fan(2 * D2)),
             ("conv_final2.bias", (F_out,), fan(2 * D2))]
    return spec


def buffer_spec(D2: int, num_blocks: int = 5) -> list:
    """``[(name, shape)]`` of the BatchNorms' running statistics."""
    return [(f"conv{k}.bn{j}.{s}", (D2,)) for k in range(num_blocks)
            for j in (0, 1) for s in ("mean", "var")]


def fourier_basis(loc: np.ndarray, K: int, device) -> tuple:
    """cos and sin of 2π(k·x + l·y) for k, l < K (kl-major) at each
    sensor: two (K², C) f32 tensors."""
    loc = np.asarray(loc, dtype=np.float64)
    k = np.repeat(np.arange(K, dtype=np.float64), K)
    l = np.tile(np.arange(K, dtype=np.float64), K)
    phi = 2.0 * np.pi * (np.outer(k, loc[:, 0]) + np.outer(l, loc[:, 1]))
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return as_t(np.cos(phi)), as_t(np.sin(phi))


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * _SQRT_HALF))


def _batch_norm(x, scale, bias, running, train: bool):
    """(y, new running (mean, var))."""
    if train:
        mean = x.mean(dim=(0, 2))
        var = ((x - mean[:, None]) ** 2).mean(dim=(0, 2))
        with torch.no_grad():
            m = BN_MOMENTUM
            new = (m * running[0] + (1 - m) * mean, m * running[1] + (1 - m) * var)
    else:
        mean, var = running
        new = running
    y = (x - mean[:, None]) / torch.sqrt(var[:, None] + BN_EPS)
    return y * scale[:, None] + bias[:, None], new


def forward(w: dict, running: dict, X, subjects, loc, cos, sin, *,
            num_blocks: int, seq2seq: bool, train: bool, centre=None,
            d_drop: float = 0.1, q=lambda t: t):
    """``(Z, new running statistics)`` of the encoder on X (B, C, T) f32
    for ``subjects`` (B,); ``centre`` is the spatial-dropout sensor of a
    training forward."""
    sa = "subject_block.spatial_attention."
    att = torch.softmax(q(w[sa + "z_re"]) @ q(cos) + q(w[sa + "z_im"]) @ q(sin),
                        dim=-1)                                      # (D1, C)
    if train:
        d = torch.sqrt(((loc - loc[int(centre)]) ** 2).sum(dim=-1))
        X = X * (d >= d_drop).to(X.dtype)[None, :, None]
    h = torch.einsum("dc,bct->bdt", q(att), q(X))

    def pointwise(x, name):
        return (torch.einsum("oi,bit->bot", q(w[name + ".weight"]), q(x))
                + w[name + ".bias"][None, :, None])

    def conv3(x, name):
        return F.conv1d(q(x), q(w[name + ".weight"]), w[name + ".bias"],
                        padding=1)

    h = pointwise(h, "subject_block.conv")
    W_sub = w["subject_block.subject_layer.weight"][subjects.long()]
    h = torch.einsum("bio,bit->bot", q(W_sub), q(h))
    new = {}
    for k in range(num_blocks):
        pre = f"conv{k}."
        x0 = h
        h = conv3(x0, pre + "conv0")
        if k > 0:
            h = h + x0
        for j, conv in ((0, None), (1, "conv1")):
            if conv is not None:
                h = conv3(h, pre + conv) + h
            bn = f"{pre}bn{j}"
            h, stats = _batch_norm(h, w[bn + ".scale"], w[bn + ".bias"],
                                   (running[bn + ".mean"], running[bn + ".var"]),
                                   train)
            new[bn + ".mean"], new[bn + ".var"] = stats
            h = _gelu(h)
        h = conv3(h, pre + "conv2a") * torch.sigmoid(conv3(h, pre + "conv2b"))
    h = _gelu(pointwise(h, "conv_final1"))
    h = _gelu(pointwise(h, "conv_final2"))
    return (h if seq2seq else h.mean(dim=2)), new
