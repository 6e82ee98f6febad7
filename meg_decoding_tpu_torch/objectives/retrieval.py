"""Retrieval / identification metrics.
Port of ``meg_decoding_tpu/objectives/retrieval.py`` (speech metrics).

Reference: ``meg_decoding/models.py:386-460`` (``Classifier`` cosine
retrieval) and ``evaluate.py:191-249`` (pairwise identification via
correlation / cosine, matching ``assets/evaluate.m``).  One matmul + top-k.
"""

from __future__ import annotations

import torch

__all__ = [
    "cosine_similarity_matrix",
    "retrieval_accuracy_from_sim",
    "retrieval_accuracy",
    "pairwise_identification",
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


def _rowwise_corr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """corr[i, j] = Pearson correlation of a_i with b_j."""
    a = _unit_rows(a - a.mean(dim=1, keepdim=True))
    b = _unit_rows(b - b.mean(dim=1, keepdim=True))
    return a @ b.T


def pairwise_identification(Z, Y, metric: str = "correlation") -> torch.Tensor:
    """For each true pair (Z_i, Y_i), the fraction of distractors Y_j (j≠i)
    with sim(Z_i, Y_i) > sim(Z_i, Y_j).  Returns per-query accuracies (B,)."""
    if metric == "correlation":
        sim = _rowwise_corr(Z.reshape(Z.shape[0], -1).to(torch.float32),
                            Y.reshape(Y.shape[0], -1).to(torch.float32))
    elif metric == "cosine":
        sim = cosine_similarity_matrix(Z, Y)
    else:
        raise ValueError(metric)
    B = sim.shape[0]
    true_sim = torch.diagonal(sim)[:, None]
    wins = (true_sim > sim).to(torch.float32)
    return wins.sum(dim=1) / max(B - 1, 1)
