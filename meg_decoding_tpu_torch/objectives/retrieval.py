"""Retrieval / identification metrics.
Port of ``meg_decoding_tpu/objectives/retrieval.py``.

Reference: ``meg_decoding/models.py:386-460`` (``Classifier`` cosine
retrieval), ``evaluate.py:32-82`` (``zero_shot_classification`` against
the 50-image gallery) and ``evaluate.py:191-249`` (pairwise identification
via correlation / cosine, matching ``assets/evaluate.m``).  One matmul +
top-k.
"""

from __future__ import annotations

import torch

__all__ = [
    "cosine_similarity_matrix",
    "retrieval_accuracy_from_sim",
    "retrieval_accuracy",
    "zero_shot_classification",
    "pairwise_identification",
    "pairwise_identification_gallery",
]

EPS = 1e-8


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=EPS)


def cosine_similarity_matrix(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sim[i, j] = cos(x_i, y_j), clamping norms at 1e-8 like the reference
    (``models.py:427``)."""
    x = x.reshape(x.shape[0], -1).to(torch.float32)
    y = y.reshape(y.shape[0], -1).to(torch.float32)
    return _unit_rows(x) @ _unit_rows(y).T


def _topk_contains(sim: torch.Tensor, targets: torch.Tensor, k: int) -> torch.Tensor:
    """For each row, is the target column within the k best scores?"""
    k = min(k, sim.shape[1])
    top_idx = torch.topk(sim, k, dim=1).indices
    return (top_idx == targets[:, None]).any(dim=-1)


def retrieval_accuracy_from_sim(sim: torch.Tensor, top_ks=(1, 10)) -> dict:
    """Top-k diagonal retrieval from a (B, B) similarity (rows = Y, columns
    = Z); any positively-scaled similarity (e.g. the CLIP logits) ranks the
    same.  Returns {f'top{k}': 0-dim tensor}."""
    targets = torch.arange(sim.shape[0], device=sim.device)
    out = {}
    for k in top_ks:
        if k == 1:
            hit = torch.argmax(sim, dim=1) == targets
        else:
            hit = _topk_contains(sim, targets, k)
        out[f"top{k}"] = hit.to(torch.float32).mean()
    return out


def retrieval_accuracy(Z, Y, top_ks=(1, 10)) -> dict:
    """Diagonal retrieval accuracy for matched batches (Z_i ↔ Y_i), scored
    as the reference does: Y rows against Z columns (``models.py:432``)."""
    sim = cosine_similarity_matrix(Z, Y).T
    return retrieval_accuracy_from_sim(sim, top_ks)


def zero_shot_classification(Z, gallery, labels, top_ks=(1, 10)) -> dict:
    """Classify each prediction against a fixed gallery by cosine similarity
    (reference ``evaluate.py:32-82``); ``labels`` are 0-indexed gallery
    rows.  Returns {f'top{k}': 0-dim tensor}."""
    sim = cosine_similarity_matrix(Z, gallery)  # (B, G)
    out = {}
    for k in top_ks:
        if k == 1:
            hit = torch.argmax(sim, dim=1) == labels
        else:
            hit = _topk_contains(sim, labels, k)
        out[f"top{k}"] = hit.to(torch.float32).mean()
    return out


def _rowwise_corr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """corr[i, j] = Pearson correlation of a_i with b_j."""
    a = _unit_rows(a - a.mean(dim=1, keepdim=True))
    b = _unit_rows(b - b.mean(dim=1, keepdim=True))
    return a @ b.T


def _similarity(Z, Y, metric: str) -> torch.Tensor:
    if metric == "correlation":
        return _rowwise_corr(Z.reshape(Z.shape[0], -1).to(torch.float32),
                             Y.reshape(Y.shape[0], -1).to(torch.float32))
    if metric == "cosine":
        return cosine_similarity_matrix(Z, Y)
    raise ValueError(metric)


def pairwise_identification_gallery(Z, gallery, target_idx,
                                    metric: str = "correlation") -> torch.Tensor:
    """Pairwise identification against an explicit candidate gallery (the
    reference's headline GOD number, ``evaluate.py:191-249``: each
    prediction against the 50-image gallery, denominator G − 1).  Returns
    per-query accuracies (B,)."""
    sim = _similarity(Z, gallery, metric)
    true_sim = sim.gather(1, target_idx[:, None])
    return (true_sim > sim).to(torch.float32).sum(dim=1) / (sim.shape[1] - 1)


def pairwise_identification(Z, Y, metric: str = "correlation") -> torch.Tensor:
    """For each true pair (Z_i, Y_i), the fraction of distractors Y_j (j≠i)
    with sim(Z_i, Y_i) > sim(Z_i, Y_j).  Returns per-query accuracies (B,)."""
    sim = _similarity(Z, Y, metric)
    B = sim.shape[0]
    true_sim = torch.diagonal(sim)[:, None]
    wins = (true_sim > sim).to(torch.float32)
    return wins.sum(dim=1) / max(B - 1, 1)
