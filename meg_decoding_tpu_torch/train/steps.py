"""Train and eval steps.  Port of ``CollateConfig``, ``LossConfig``,
``make_train_step`` and ``make_eval_step`` from
``meg_decoding_tpu/train/steps.py``.

One train step = collate (baseline + robust scale + clamp, outside
autograd) → encoder in training mode → loss → gradients → Adam → BN
running statistics → top-1/top-10.  A step whose loss or global gradient
norm is not finite is skipped on the device: parameters, Adam state and BN
statistics keep their old values, and the step counts as ``skipped``.
Nothing in the step waits for the device.

Loss kinds, as the reference entry points (SURVEY §2.9):
* ``clip``            — train.py / train_wowandb_cv.py;
* ``clip`` + ``same_label_weight`` — train_wowandb_cv_contrastive.py;
* ``mse``             — train_wowandb_cv_regression.py, with the optional
                        L2 penalty on the encoder's parameters
                        (``l2_weight``, train_regression.py:250-253);
* ``classification``  — train_my_classifier.py, against a gallery, with
                        three criteria.
"""

from __future__ import annotations

import dataclasses

import torch

from meg_decoding_tpu_torch.models.layers import commit_running_stats
from meg_decoding_tpu_torch.objectives.clip import clip_loss
from meg_decoding_tpu_torch.objectives.losses import (
    clip_like_classification_loss,
    mse_loss,
    same_label_loss,
)
from meg_decoding_tpu_torch.objectives.retrieval import (
    retrieval_accuracy,
    retrieval_accuracy_from_sim,
)
from meg_decoding_tpu_torch.ops.scaling import (
    collate_preprocess,
    collate_preprocess_cached,
)
from meg_decoding_tpu_torch.train.optim import Adam, global_norm
from meg_decoding_tpu_torch.train.state import TrainState

__all__ = ["LossConfig", "CollateConfig", "make_train_step", "make_eval_step"]


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
    kind: str = "clip"              # clip | mse | classification
    reduction: str = "mean"
    same_label_weight: float = 0.0  # > 0 adds same_label_loss (clip kind)
    l2_weight: float = 0.0          # > 0 adds l2·Σ p² over the encoder
    criterion: str = "crossentropy"  # classification kind
    smooth_value: float = 0.1
    label_offset: int = 0           # GOD vec_index is 1-indexed → offset 1
    grad_norms: bool = False        # add the global gradient norm to the metrics
    # false freezes the CLIP temperature at init_temperature (reference
    # loss.py:140-143: a requires_grad=False tensor, not a parameter)
    temp_trainable: bool = True
    # 'factored' (raw dot, norms folded into the (B, B) logits) or
    # 'normalized' (normalize-then-dot, the reference's op order)
    clip_impl: str = "factored"

    def __post_init__(self):
        if self.kind not in ("clip", "mse", "classification"):
            raise ValueError(f"unknown loss kind {self.kind!r} "
                             "(clip, mse, classification)")


def _l2_penalty(model) -> torch.Tensor:
    """Σ p² over the encoder's parameters (never the CLIP temperature)."""
    return sum((p * p).sum() for p in model.parameters())


def _compute_loss(loss_cfg: LossConfig, Z, Y, labels, temp, model,
                  gallery=None, gallery_self_sim=None, train=True):
    """Returns ``(loss, sim)``: ``sim`` is the CLIP logits (rows = Y,
    columns = Z) when the loss computed them, else None — the step then
    ranks with them (any positive scale ranks alike)."""
    sim = None
    if loss_cfg.kind == "clip":
        # rows = Y, columns = Z, as the JAX step calls clip_loss(Y, Z)
        sim, loss = clip_loss(Y, Z, temp, reduction=loss_cfg.reduction,
                              return_logits=True, impl=loss_cfg.clip_impl)
        if loss_cfg.same_label_weight > 0.0 and labels is not None:
            loss = loss + loss_cfg.same_label_weight * same_label_loss(Z, labels)
    elif loss_cfg.kind == "mse":
        loss = mse_loss(Y, Z)
    else:  # classification
        if gallery is None or labels is None:
            raise ValueError("the classification loss needs a gallery and labels")
        loss = clip_like_classification_loss(
            Z, labels - loss_cfg.label_offset, gallery, temp,
            criterion=loss_cfg.criterion, train=train,
            smooth_value=loss_cfg.smooth_value,
            gallery_self_similarity=gallery_self_sim)
    if loss_cfg.l2_weight > 0.0:
        loss = loss + loss_cfg.l2_weight * _l2_penalty(model)
    return loss, sim


def _accuracy(sim, Z, Y, top_ks) -> dict:
    """Top-k retrieval: from the CLIP logits when the loss made them, else
    from the cosine similarity of Z and Y."""
    if sim is not None:
        return retrieval_accuracy_from_sim(sim.detach(), top_ks=top_ks)
    return retrieval_accuracy(Z.detach(), Y, top_ks=top_ks)


def make_train_step(model, optimizer: Adam, loss_cfg: LossConfig,
                    collate_cfg: CollateConfig, gallery=None,
                    gallery_self_sim=None):
    """Build the train step.

    Returns ``step(state, X, Y, subject_idxs, labels=None, centre=None,
    collate_stats=None) → (state, metrics)``: ``state`` is updated in place
    and returned; ``labels`` feed the classification and same-label losses;
    ``centre`` is the spatial-dropout centre, drawn from ``state.generator``
    when None; ``collate_stats`` (B, 2C), the batch's rows of
    ``data/gwilliams.py:compute_collate_stats`` ([:, :C] median, [:, C:]
    IQR), makes the collate apply those fits instead of computing the
    percentiles (``collate_preprocess_cached``).
    ``gallery`` (G, F) and its cosine self-similarity are the
    classification loss's.  Metrics are 0-dim tensors on the device:
    ``loss``, ``temp`` (after the update), ``skipped``, ``top1``, ``top10``
    (and ``grad_norm`` with ``loss_cfg.grad_norms``); loss and accuracies
    read 0 on a skipped step."""

    def step(state: TrainState, X, Y, subject_idxs, labels=None, centre=None,
             collate_stats=None):
        model.train()
        if collate_cfg.enabled:
            with torch.no_grad():
                if collate_stats is not None:
                    C = X.shape[1]
                    X = collate_preprocess_cached(
                        X, collate_stats[:, :C], collate_stats[:, C:],
                        collate_cfg.baseline_len_samp, collate_cfg.clamp_lim,
                        collate_cfg.clamp)
                else:
                    X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                           collate_cfg.clamp_lim,
                                           collate_cfg.clamp)
        Z = model(X, subject_idxs, centre=centre, generator=state.generator)
        temp = state.temp if loss_cfg.temp_trainable else state.temp.detach()
        loss, sim = _compute_loss(loss_cfg, Z, Y, labels, temp, model,
                                  gallery, gallery_self_sim, train=True)
        params = state.params()
        names = [k for k, p in params.items() if p.requires_grad]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names], allow_unused=True)))
        loss = loss.detach()
        gnorm = global_norm(grads.values())
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        optimizer.update(params, grads, state.opt_state, ok)
        commit_running_stats(model, ok)
        state.step += 1

        zero = torch.zeros((), dtype=torch.float32, device=loss.device)
        metrics = {"loss": torch.where(ok, loss, zero),
                   "temp": state.temp.detach().clone(),
                   "skipped": 1.0 - ok.to(torch.float32)}
        if loss_cfg.grad_norms:
            metrics["grad_norm"] = torch.where(ok, gnorm, zero)
        acc = _accuracy(sim, Z, Y, (1, 10))
        metrics.update({k: torch.where(ok, v, zero) for k, v in acc.items()})
        return state, metrics

    return step


def make_eval_step(model, loss_cfg: LossConfig, collate_cfg: CollateConfig,
                   gallery=None, gallery_self_sim=None, top_ks=(1, 10)):
    """Build the eval step: collate → forward (running BN stats, no dropout)
    → loss and retrieval metrics.

    Returns ``step(X, Y, subject_idxs, temp, labels=None) → (metrics, Z)``;
    ``temp`` is the CLIP temperature (the JAX step reads it from
    ``params['loss']``), metrics are 0-dim tensors on the model's device."""

    @torch.no_grad()
    def step(X, Y, subject_idxs, temp, labels=None):
        model.eval()
        if collate_cfg.enabled:
            X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                   collate_cfg.clamp_lim, collate_cfg.clamp)
        Z = model(X, subject_idxs)
        temp = torch.as_tensor(temp, dtype=torch.float32, device=Z.device)
        loss, sim = _compute_loss(loss_cfg, Z, Y, labels, temp, model,
                                  gallery, gallery_self_sim, train=False)
        metrics = {"loss": loss, "temp": temp}
        metrics.update(_accuracy(sim, Z, Y, top_ks))
        return metrics, Z

    return step
