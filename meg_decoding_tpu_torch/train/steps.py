"""Train and eval steps.  Port of ``CollateConfig``, ``LossConfig`` (CLIP
only), ``make_train_step`` and ``make_eval_step`` from
``meg_decoding_tpu/train/steps.py``.

One train step = collate (baseline + robust scale + clamp, outside
autograd) → encoder in training mode → CLIP loss → gradients → Adam →
BN running statistics → top-1/top-10 from the loss's own logits.  A step
whose loss or global gradient norm is not finite is skipped on the device:
parameters, Adam state and BN statistics keep their old values, and the
step counts as ``skipped``.  Nothing in the step waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch

from meg_decoding_tpu_torch.models.layers import commit_running_stats
from meg_decoding_tpu_torch.objectives.clip import clip_loss
from meg_decoding_tpu_torch.objectives.retrieval import (
    retrieval_accuracy_from_sim,
)
from meg_decoding_tpu_torch.ops.scaling import collate_preprocess
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
    kind: str = "clip"
    reduction: str = "mean"
    # 'factored' (raw dot, norms folded into the (B, B) logits) or
    # 'normalized' (normalize-then-dot, the reference's op order)
    clip_impl: str = "factored"
    # false freezes the CLIP temperature at init_temperature (reference
    # loss.py:140-143: a requires_grad=False tensor, not a parameter)
    temp_trainable: bool = True
    grad_norms: bool = False  # add the global gradient norm to the metrics

    def __post_init__(self):
        if self.kind != "clip":
            raise NotImplementedError(
                f"loss kind {self.kind!r} is not ported yet (clip only)")


def make_train_step(model, optimizer: Adam, loss_cfg: LossConfig,
                    collate_cfg: CollateConfig):
    """Build the train step.

    Returns ``step(state, X, Y, subject_idxs, centre=None) → (state,
    metrics)``: ``state`` is updated in place and returned; ``centre`` is
    the spatial-dropout centre, drawn from ``state.generator`` when None.
    Metrics are 0-dim tensors on the device: ``loss``, ``temp`` (after the
    update), ``skipped``, ``top1``, ``top10`` (and ``grad_norm`` with
    ``loss_cfg.grad_norms``); loss and accuracies read 0 on a skipped
    step."""

    def step(state: TrainState, X, Y, subject_idxs, centre=None):
        model.train()
        if collate_cfg.enabled:
            with torch.no_grad():
                X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                       collate_cfg.clamp_lim, collate_cfg.clamp)
        Z = model(X, subject_idxs, centre=centre, generator=state.generator)
        temp = state.temp if loss_cfg.temp_trainable else state.temp.detach()
        # rows = Y, columns = Z, as the JAX step calls clip_loss(Y, Z)
        sim, loss = clip_loss(Y, Z, temp, reduction=loss_cfg.reduction,
                              return_logits=True, impl=loss_cfg.clip_impl)
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
        acc = retrieval_accuracy_from_sim(sim.detach(), top_ks=(1, 10))
        metrics.update({k: torch.where(ok, v, zero) for k, v in acc.items()})
        return state, metrics

    return step


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
