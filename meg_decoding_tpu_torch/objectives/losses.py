"""Auxiliary losses: MSE, same-label pull, GOD classification-vs-gallery.
Port of ``meg_decoding_tpu/objectives/losses.py``.

Reference: ``meg_decoding/utils/loss.py`` — ``MSELoss`` (43-52),
``SameLabelLoss`` (17-38), ``MyCLIPLikeClassificationLoss`` (115-249).
The reference's Python loops are vectorized; gallery features are passed in
as tensors (the reference loads them from disk inside the loss,
``loss.py:149-166``).  The semantics are the JAX package's, which differ
from the reference where the reference has a bug (see ``same_label_loss``
and ``smooth_category_targets``).
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.objectives.clip import _normalize

__all__ = [
    "mse_loss",
    "same_label_loss",
    "same_label_loss_sharded",
    "classification_logits",
    "clip_like_classification_loss",
    "smooth_category_targets",
]


def mse_loss(Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Squared error summed over all non-batch dims, averaged over the
    batch (reference ``loss.py:43-52``)."""
    se = (Y - Z) ** 2
    return se.reshape(se.shape[0], -1).sum(dim=-1).mean()


def same_label_loss(Z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over ordered pairs (i, j ≠ i) of equal label of
    ``mean((Z[i] − Z[j])²)``; 0 when no two labels are equal.  The
    reference anchors at ``Z[label]`` (an index bug, ``loss.py:28-37``); the
    anchor here is ``Z[i]``, as in the JAX package."""
    B = Z.shape[0]
    Z = Z.reshape(B, -1)
    eye = torch.eye(B, dtype=torch.bool, device=Z.device)
    mask = (labels[:, None] == labels[None, :]) & ~eye
    d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).mean(dim=-1)  # (B, B)
    count = torch.clamp(mask.sum(), min=1)
    return torch.where(mask, d2, torch.zeros_like(d2)).sum() / count


def same_label_loss_sharded(Z_local: torch.Tensor, labels_local: torch.Tensor,
                            mesh) -> torch.Tensor:
    """This rank's share of ``same_label_loss`` over the global batch of a
    data-parallel ``mesh``: the pairs whose first member is one of this
    rank's rows, against every row of every rank (Z all-gathered with
    autograd), over the global count of equal-label pairs.  The shares
    sum to the global loss."""
    b = Z_local.shape[0]
    Zf = Z_local.reshape(b, -1)
    Z_all = mesh.all_gather(Zf)
    labels_all = mesh.all_gather(labels_local)
    B = labels_all.shape[0]
    rows = mesh.rank * b + torch.arange(b, device=Zf.device)
    not_self = rows[:, None] != torch.arange(B, device=Zf.device)[None, :]
    mask = (labels_local[:, None] == labels_all[None, :]) & not_self
    count = torch.clamp((labels_all[:, None] == labels_all[None, :]).sum() - B,
                        min=1)
    d2 = ((Zf[:, None, :] - Z_all[None, :, :]) ** 2).mean(dim=-1)  # (b, B)
    return torch.where(mask, d2, torch.zeros_like(d2)).sum() / count


def smooth_category_targets(labels: torch.Tensor, gallery_size: int,
                            same_category_length: int = 8,
                            smooth_value: float = 0.1) -> torch.Tensor:
    """Smoothed one-hot targets over the training gallery: 1 at the label,
    ``smooth_value`` at the other images of its 8-image category block
    ``l // 8`` (the reference's ``l % 8`` sits in dead code,
    ``loss.py:175-187``).  ``labels`` are 0-indexed."""
    B = labels.shape[0]
    cols = torch.arange(gallery_size, device=labels.device)[None, :]
    l_cat = (labels // same_category_length)[:, None]
    block = (cols >= l_cat * same_category_length) & (
        cols < (l_cat + 1) * same_category_length)
    targets = torch.where(block, smooth_value, 0.0).to(torch.float32)
    targets[torch.arange(B, device=labels.device), labels] = 1.0
    return targets


def classification_logits(x: torch.Tensor, gallery: torch.Tensor,
                          temp) -> torch.Tensor:
    """Cosine logits of predictions against a fixed gallery, scaled by
    e^temp (reference ``loss.py:217-229``), in f32."""
    x = _normalize(x.reshape(x.shape[0], -1)).to(torch.float32)
    g = _normalize(gallery.reshape(gallery.shape[0], -1)).to(torch.float32)
    return (x @ g.T) * torch.exp(temp)


def _nll_of_labels(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(1, labels[:, None]).mean()


def clip_like_classification_loss(x: torch.Tensor, labels: torch.Tensor,
                                  gallery: torch.Tensor, temp,
                                  criterion: str = "crossentropy",
                                  train: bool = True,
                                  smooth_value: float = 0.1,
                                  same_category_length: int = 8,
                                  gallery_self_similarity: torch.Tensor | None = None):
    """GOD classification-against-gallery loss, three criteria (reference
    ``loss.py:120-136, 190-244``).  ``labels`` are 0-indexed gallery rows.

    - ``crossentropy``: CE against the smoothed category targets (train) or
      the hard labels (eval).
    - ``binary_crossentropy``: sigmoid + BCE against the same targets
      (one-hot in eval), probabilities clipped to [1e-7, 1 − 1e-7].
    - ``similarity_crossentropy``: soft targets = softmax of the gallery's
      self-similarity row scaled by e^temp (train); hard labels (eval)."""
    logits = classification_logits(x, gallery, temp)
    G = gallery.shape[0]

    if criterion == "crossentropy":
        logp = torch.log_softmax(logits, dim=-1)
        if train:
            targets = smooth_category_targets(labels, G, same_category_length,
                                              smooth_value)
            return -(targets * logp).sum(dim=-1).mean()
        return _nll_of_labels(logp, labels)

    if criterion == "binary_crossentropy":
        if train:
            targets = smooth_category_targets(labels, G, same_category_length,
                                              smooth_value)
        else:
            targets = torch.nn.functional.one_hot(labels, G).to(torch.float32)
        # jnp.clip's gradient: half at a bound (sigmoid rounds to 1 − 1e-7
        # in f32 often, where 1/(1 − p) is ~1e7); torch.clamp passes all of it
        p = torch.sigmoid(logits)
        p = torch.minimum(torch.maximum(p, p.new_tensor(1e-7)),
                          p.new_tensor(1 - 1e-7))
        return -(targets * torch.log(p) + (1 - targets) * torch.log(1 - p)).mean()

    if criterion == "similarity_crossentropy":
        logp = torch.log_softmax(logits, dim=-1)
        if train:
            if gallery_self_similarity is None:
                raise ValueError("similarity_crossentropy needs the gallery's "
                                 "self-similarity in training")
            rows = gallery_self_similarity[labels]  # (B, G)
            targets = torch.softmax(rows * torch.exp(temp), dim=-1)
            return -(targets * logp).sum(dim=-1).mean()
        return _nll_of_labels(logp, labels)

    raise ValueError(f"unknown criterion {criterion!r}")
