"""Eval step: collate → eval-mode encoder → CLIP loss + retrieval metrics.
Port of ``CollateConfig``, ``LossConfig`` (CLIP only) and ``make_eval_step``
from ``meg_decoding_tpu/train/steps.py``; the train step comes with the
training slice.
"""

from __future__ import annotations

import dataclasses

import torch

from meg_decoding_tpu_torch.objectives.clip import clip_loss
from meg_decoding_tpu_torch.objectives.retrieval import (
    retrieval_accuracy_from_sim,
)
from meg_decoding_tpu_torch.ops.scaling import collate_preprocess

__all__ = ["LossConfig", "CollateConfig", "make_eval_step"]


@dataclasses.dataclass(frozen=True)
class CollateConfig:
    """Batch-time collate: baseline correction, RobustScaler, clamp.  The
    percentiles always come from the quantile kernel on the card (its plain
    version on the CPU), so there is no percentile-backend choice here."""
    baseline_len_samp: int = 0
    clamp_lim: float = 20.0
    clamp: bool = True
    enabled: bool = True


@dataclasses.dataclass(frozen=True)
class LossConfig:
    kind: str = "clip"
    reduction: str = "mean"
    # 'factored' (raw dot, norms folded into the (B, B) logits) or
    # 'normalized' (normalize-then-dot, the reference's op order)
    clip_impl: str = "factored"

    def __post_init__(self):
        if self.kind != "clip":
            raise NotImplementedError(
                f"loss kind {self.kind!r} is not ported yet (clip only)")


def make_eval_step(model, loss_cfg: LossConfig, collate_cfg: CollateConfig,
                   top_ks=(1, 10)):
    """Build the eval step: collate → forward (running BN stats, no dropout)
    → CLIP loss and retrieval metrics from the loss's own logits.

    Returns ``step(X, Y, subject_idxs, temp) → (metrics, Z)``; ``temp`` is
    the CLIP temperature (the JAX step reads it from ``params['loss']``),
    metrics are 0-dim tensors on the model's device."""

    @torch.no_grad()
    def step(X, Y, subject_idxs, temp):
        model.eval()
        if collate_cfg.enabled:
            X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                   collate_cfg.clamp_lim, collate_cfg.clamp)
        Z = model(X, subject_idxs)
        temp = torch.as_tensor(temp, dtype=torch.float32, device=Z.device)
        # rows = Y, columns = Z, as the JAX step calls clip_loss(Y, Z)
        sim, loss = clip_loss(Y, Z, temp, reduction=loss_cfg.reduction,
                              return_logits=True, impl=loss_cfg.clip_impl)
        metrics = {"loss": loss, "temp": temp}
        metrics.update(retrieval_accuracy_from_sim(sim, top_ks=top_ks))
        return metrics, Z

    return step
