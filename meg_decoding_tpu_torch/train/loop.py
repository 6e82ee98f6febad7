"""Epoch loop: sampler → train steps → test pools → metrics → checkpoint.
Port of ``fit``, ``fit_scan``, ``steps_per_epoch`` and
``resume_if_requested`` from ``meg_decoding_tpu/train/loop.py`` (single
device).  Two forms of train set: a stochastic speech pool, whose gather
takes a generator for its random pairing, and a ``PackedDataset`` (GOD),
whose gather is plain indexing.  A train set spilled to host memory
(``host_resident``) streams its batches through the prefetch
(``data/prefetch.py``; ``prefetch: N``, 2 by default then), so that each
batch's copy to the card runs under the previous step.  ``profile_dir``
traces the epoch ``profile_epoch`` (``utils/profiling.py``).
``fit_scan`` drives the whole-epoch forms of ``train/scan_loop.py``
instead: one call an epoch.

Reference skeleton: ``train.py:178-274`` (epoch loop with per-batch
updates, a test pass, epoch metric means, model_last each epoch) and
``train_wowandb_cv.py:274-357`` (model_best on the best test top-10).

Every random draw of an epoch comes from a ``torch.Generator`` seeded from
(seed, epoch, …), never from state carried across epochs, so a resumed run
samples exactly the batches a continuous run would have.  Steps return
device tensors; the host reads them once per epoch.
"""

from __future__ import annotations

import glob
import json
import os
import warnings
from typing import Callable

import numpy as np
import torch

from meg_decoding_tpu_torch.data.packed import PackedDataset
from meg_decoding_tpu_torch.data.prefetch import prefetch_to_device, to_device
from meg_decoding_tpu_torch.data.sampling import (
    sample_with_replacement,
    shuffle_batches,
)
from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
from meg_decoding_tpu_torch.utils.logging import RunLogger
from meg_decoding_tpu_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["fit", "fit_scan", "steps_per_epoch", "resume_if_requested",
           "derived_generator"]

_SAMPLE, _TEST, _GATHER = 0, 1, 2  # streams of an epoch's generators


def derived_generator(*path: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from a path of ints, e.g. (seed,
    epoch, stream, step) — the counterpart of ``jax.random.fold_in``."""
    seed = int(np.random.SeedSequence([int(p) for p in path]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _mean_metrics(history: list[dict]) -> dict:
    """Per-epoch metric means.  Steps skipped by the non-finite guard carry
    metrics masked to 0 (train/steps.py); averaging those zeros in would
    underreport the loss.  So every metric except ``skipped`` and ``temp``
    averages over the valid steps only; those two average over all steps."""
    if not history:
        return {}
    cols = {k: torch.stack([torch.as_tensor(h[k]) for h in history])
            .to(torch.float64).cpu().numpy() for k in history[0]}
    if "skipped" not in cols:
        return {k: float(v.mean()) for k, v in cols.items()}
    valid = cols["skipped"] == 0.0
    unmasked = ("skipped", "temp")
    out = {k: (float(v[valid].mean()) if valid.any() else 0.0)
           for k, v in cols.items() if k not in unmasked}
    for k in unmasked:
        if k in cols:
            out[k] = float(cols[k].mean())
    return out


def _test_pool_starts(n: int, pool: int, sweep: bool) -> list[int]:
    """Window starts covering the test split with pools of exactly ``pool``
    elements: non-overlapping windows plus a tail-covering final window.
    ``sweep=False`` reproduces the reference's single-batch test pass
    (train.py:223-245)."""
    if not sweep or n <= pool:
        return [0]
    starts = list(range(0, n - pool + 1, pool))
    if starts[-1] + pool < n:
        starts.append(n - pool)
    return starts


def _eval_test_pools(cfg, test_set, eval_step, state, test_size: int,
                     seed: int, epoch: int, with_labels: bool) -> dict:
    """Epoch test pass: every pool of ``test_size`` segments of the shuffled
    test split is scored and the metrics averaged (``test_sweep: false``
    scores one pool, as the reference does).  A ``PackedDataset`` pool is a
    plain gather; any other draws its sessions from a derived generator.
    A host-resident pool's batch is copied to the state's device."""
    n = len(test_set)
    dev = state.step.device
    perm = torch.randperm(n, generator=derived_generator(seed, epoch, _TEST)).numpy()
    sweep = bool(cfg.get("test_sweep", True))
    hist = []
    for j, s in enumerate(_test_pool_starts(n, test_size, sweep)):
        idx = perm[s:s + test_size]
        if isinstance(test_set, PackedDataset):
            batch = test_set.gather(idx)
        else:
            batch = test_set.gather(
                idx, generator=derived_generator(seed, epoch, _TEST, j + 1))
        batch = to_device(batch, dev)
        labels = batch[3] if with_labels else None
        m, _ = eval_step(*batch[:3], state.temp.detach(), labels)
        hist.append(m)
    return _mean_metrics(hist)


def fit(cfg, train_set, test_set, state, train_step: Callable,
        eval_step: Callable, logger: RunLogger,
        ckpt: CheckpointManager | None = None, seed: int = 0,
        start_epoch: int = 0, with_labels: bool = False):
    """Run the training loop; returns ``(state, best_metrics)``.

    With a ``PackedDataset`` ``train_set`` (GOD), each batch is
    ``train_set.gather(idx)`` and the step is ``train_step(state, X, Y,
    subject_idxs[, labels])`` (``train/steps.py``), with the labels when
    ``with_labels`` (classification and same-label losses).  Otherwise
    ``train_set`` is a stochastic pool, each batch is
    ``train_set.gather(idx, generator=…)`` and the step
    ``train_step(state, *batch)``.  The generator is derived from (seed,
    epoch, step), as JAX derives a key per call (``train/loop.py:143-172``),
    so a resumed run draws what a continuous one would.  A ``SpeechPool``
    gives ``(X, Y, subject_idxs)`` for ``make_train_step``; the train CLI
    wraps the fused Gwilliams step so that its pool gives the segment ids
    and the generator, and the step gathers.  The test pools call
    ``eval_step(X, Y, subject_idxs, temp, labels)``.  ``start_epoch``
    continues the epoch numbering after a resume.

    A ``train_set`` with ``host_resident`` gathers on the host, and its
    batches reach the state's device through ``prefetch_to_device`` with
    ``cfg.prefetch`` batches in flight (2 by default; 0 copies each batch
    in the loop).  With ``cfg.profile_dir`` the train steps of epoch
    ``cfg.profile_epoch`` (1 by default, as JAX) are traced into it."""
    epochs = int(cfg.epochs)
    batch_size = min(int(cfg.batch_size), len(train_set))
    use_sampler = bool(cfg.get("use_sampler", True))
    updates = int(cfg.get("updates", max(len(train_set) // batch_size, 1)))
    test_size = min(len(test_set), int(cfg.get("test_size", batch_size)))
    best_top10, best_metrics = -1.0, {}
    timer = StepTimer()
    packed = isinstance(train_set, PackedDataset)
    dev = state.step.device
    host_resident = bool(getattr(train_set, "host_resident", False))
    prefetch_n = int(cfg.get("prefetch", 2 if host_resident else 0) or 0)
    profile_dir = cfg.get("profile_dir")
    profile_epoch = int(cfg.get("profile_epoch", 1)) if profile_dir else -1

    for epoch in range(start_epoch, epochs):
        egen = derived_generator(seed, epoch, _SAMPLE)
        if use_sampler:
            idx_epoch = sample_with_replacement(egen, len(train_set), updates,
                                                batch_size)
        else:
            idx_epoch = shuffle_batches(egen, len(train_set), batch_size)

        def gathered_batches(epoch=epoch, idx_epoch=idx_epoch):
            for step_i, idx in enumerate(idx_epoch):
                with timer.phase("gather"):
                    if packed:
                        batch = train_set.gather(idx)[:4 if with_labels else 3]
                    else:
                        batch = train_set.gather(
                            idx, generator=derived_generator(
                                seed, epoch, _GATHER, step_i))
                yield batch

        if prefetch_n > 0:
            batch_iter = prefetch_to_device(gathered_batches(),
                                            size=prefetch_n, device=dev)
        elif host_resident:
            batch_iter = (to_device(b, dev) for b in gathered_batches())
        else:
            batch_iter = gathered_batches()

        train_hist = []
        with profile_trace(profile_dir if epoch == profile_epoch else None):
            for batch in batch_iter:
                with timer.phase("step"):
                    state, metrics = train_step(state, *batch)
                train_hist.append(metrics)

        tm = _mean_metrics(train_hist)
        best_top10, best_metrics = _end_epoch(
            cfg, test_set, eval_step, state, test_size, seed, epoch,
            with_labels, tm, timer.means_ms(), logger, ckpt, best_top10,
            best_metrics)
        timer.reset()

    return state, best_metrics


def _end_epoch(cfg, test_set, eval_step, state, test_size: int, seed: int,
               epoch: int, with_labels: bool, tm: dict, extra: dict,
               logger: RunLogger, ckpt: CheckpointManager | None,
               best_top10: float, best_metrics: dict):
    """An epoch's end, in ``fit`` and ``fit_scan``: abort before the
    checkpoint when every step was skipped or the loss is not finite, else
    the test pools, the log row, model_last and (on a better test top-10)
    model_best.  Returns the new ``(best_top10, best_metrics)``."""
    epochs = int(cfg.epochs)
    # the step already skips a batch with a non-finite loss or gradient;
    # abort when the whole epoch produced nothing, or a non-finite value
    # got through anyway — before it overwrites the last good checkpoint
    if tm.get("skipped", 0.0) >= 1.0:
        raise FloatingPointError(
            f"every step of epoch {epoch} was skipped (non-finite "
            "loss/grads) — state NOT checkpointed; restore model_last "
            "and lower the learning rate")
    if not np.isfinite(tm.get("loss", 0.0)):
        raise FloatingPointError(
            f"non-finite training loss at epoch {epoch}: "
            f"{tm.get('loss')} — state NOT checkpointed; restore "
            "model_last and lower the learning rate")
    test_metrics = _eval_test_pools(cfg, test_set, eval_step, state,
                                    test_size, seed, epoch, with_labels)
    em = {f"test_{k}": float(v) for k, v in test_metrics.items()}
    row = {"epoch": epoch, **{f"train_{k}": v for k, v in tm.items()},
           **em, **extra}
    logger.log(row)
    logger.summary(epoch, epochs, row)

    improved = em.get("test_top10", -1.0) > best_top10
    if improved:
        best_top10 = em.get("test_top10", -1.0)
        best_metrics = row
    if ckpt is not None:
        ckpt.save("model_last", state)
        if improved:
            ckpt.save("model_best", state)
    return best_top10, best_metrics


def fit_scan(cfg, train_set, test_set, state, scan_epoch: Callable,
             eval_step: Callable, logger: RunLogger,
             ckpt: CheckpointManager | None = None, seed: int = 0,
             start_epoch: int = 0):
    """Epoch driver over a whole-epoch form (``train/scan_loop.py``): one
    ``scan_epoch(state, generator)`` call an epoch, its generator on the
    state's device seeded from (seed, epoch), the metrics read once, then
    the test pools, the log and the checkpoints as in ``fit`` (and its
    aborts).  Returns ``(state, best_metrics)``."""
    epochs = int(cfg.epochs)
    test_size = min(len(test_set), int(cfg.get("test_size", cfg.batch_size)))
    dev = state.step.device
    best_top10, best_metrics = -1.0, {}
    for epoch in range(start_epoch, epochs):
        state, means = scan_epoch(
            state, derived_generator(seed, epoch, _SAMPLE, device=dev))
        tm = {k: float(v) for k, v in means.items()}
        best_top10, best_metrics = _end_epoch(
            cfg, test_set, eval_step, state, test_size, seed, epoch, False,
            tm, {}, logger, ckpt, best_top10, best_metrics)
    return state, best_metrics


def steps_per_epoch(cfg, n_train: int) -> int:
    """Update steps per epoch, matching ``fit``'s batching: the fixed
    ``updates`` with ``use_sampler``, else ``n_train // batch_size``."""
    bs = max(min(int(cfg.batch_size), n_train), 1)
    if bool(cfg.get("use_sampler", True)):
        return int(cfg.get("updates", max(n_train // bs, 1)))
    return max(n_train // bs, 1)


def resume_if_requested(cfg, ckpt: CheckpointManager, state, save_root: str,
                        steps_per_epoch_n: int):
    """With ``cfg.resume``, restore model_last and continue the epoch
    numbering at (largest logged epoch) + 1 over every run log under
    ``save_root/runs``, capped by the restored step count: the log is
    written before the checkpoint, so a crash between the two leaves the
    log one epoch ahead and that epoch is trained again.
    Returns ``(state, start_epoch)``."""
    if not (cfg.get("resume", False) and ckpt.exists("model_last")):
        return state, 0
    try:
        state = ckpt.restore("model_last", state)
    except FileNotFoundError as e:
        # only a partial first save is on disk: start fresh, not fail
        warnings.warn(f"resume requested but no restorable checkpoint ({e}); "
                      "starting from scratch")
        return state, 0
    last_epoch = -1
    for log in glob.glob(os.path.join(save_root, "runs", "*", "metrics.jsonl")):
        with open(log) as f:
            for line in f:
                last_epoch = max(last_epoch, int(json.loads(line).get("epoch", -1)))
    step = int(state.step)
    start_epoch = min(last_epoch + 1, step // max(int(steps_per_epoch_n), 1))
    print(f"resumed from model_last at epoch {start_epoch} (step {step})")
    return state, start_epoch
