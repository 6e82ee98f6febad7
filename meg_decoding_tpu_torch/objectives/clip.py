"""CLIP-style symmetric InfoNCE loss with a temperature.
Port of ``meg_decoding_tpu/objectives/clip.py`` (single device).

Reference: ``meg_decoding/utils/loss.py:55-112`` (``CLIPLoss``): L2-normalize
x and y, ``logits = x @ y.T * exp(temp)``, then
``(CE(logits, arange) + CE(logits.T, arange)) / 2``.
"""

from __future__ import annotations

import torch

__all__ = ["clip_loss", "clip_logits"]

EPS = 1e-12


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """L2-normalize over every non-batch axis, in f32, rounded once back to
    the input dtype.  The epsilon clamps the sum of squares INSIDE the sqrt
    (a zero row then has a finite gradient)."""
    axes = tuple(range(1, v.dim()))
    v32 = v.to(torch.float32)
    norm = torch.sqrt(torch.clamp((v32 * v32).sum(dim=axes, keepdim=True),
                                  min=EPS * EPS))
    return (v32 / norm).to(v.dtype)


def _row_norms(v: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norm over every non-batch axis, (B, ...) → (B,) in f32,
    with the same epsilon placement as ``_normalize``."""
    axes = tuple(range(1, v.dim()))
    v32 = v.to(torch.float32)
    return torch.sqrt(torch.clamp((v32 * v32).sum(dim=axes), min=EPS * EPS))


def _cosine_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, ...) × (B, ...) → (B, B) contracting all non-batch axes, f32."""
    return torch.matmul(x.reshape(x.shape[0], -1).to(torch.float32),
                        y.reshape(y.shape[0], -1).to(torch.float32).T)


def clip_logits(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor,
                impl: str = "factored") -> torch.Tensor:
    """Temperature-scaled cosine-similarity logits (B, B).

    ``'factored'``: dot the raw embeddings and rescale the (B, B) logits by
    the outer product of inverse row norms.  ``'normalized'``: normalize,
    then dot (the reference's op order)."""
    if impl == "factored":
        g = _cosine_logits(x, y)
        inv = torch.exp(temp) / (_row_norms(x)[:, None] * _row_norms(y)[None, :])
        return g * inv
    if impl == "normalized":
        return _cosine_logits(_normalize(x), _normalize(y)) * torch.exp(temp)
    raise ValueError(f"unknown clip_logits impl {impl!r}")


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   reduction: str) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    return nll.mean() if reduction == "mean" else nll.sum()


def clip_loss(x, y, temp, reduction: str = "mean", return_logits: bool = False,
              impl: str = "factored"):
    """Symmetric InfoNCE over the batch.  x, y: (B, ...)."""
    logits = clip_logits(x, y, temp, impl=impl)
    targets = torch.arange(logits.shape[0], device=logits.device)
    loss = (_cross_entropy(logits, targets, reduction)
            + _cross_entropy(logits.T, targets, reduction)) / 2.0
    if return_logits:
        return logits, loss
    return loss
