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

``fit`` runs its step (a ``TrainStep``, ``train/steps.py``) as one
captured CUDA graph, replayed once a step (``train/graph.py``: the
counterpart of ``jax.jit(train_step)``; on the CPU the same route runs
the step's body eagerly), and the whole-epoch forms replay theirs
``updates`` times an epoch: on a device-resident set and on one spilled
to host memory (its batches reach the graph's inputs by a device-to-device
copy after the prefetch's), on one device and under a data-parallel mesh
(the graph holds the collectives).  The test pools of ``fit`` and
``fit_scan`` replay one captured graph of the eval step's body
(``EvalStep``, the counterpart of ``jax.jit(eval_step)``), captured at
the first pool of the call: every pool has one shape
(``_test_pool_starts``).  The train graph and the eval graph read the
same parameters and BN buffers, which the step writes in place, so each
epoch's pools see that epoch's weights.

Reference skeleton: ``train.py:178-274`` (epoch loop with per-batch
updates, a test pass, epoch metric means, model_last each epoch) and
``train_wowandb_cv.py:274-357`` (model_best on the best test top-10).

Every random draw of an epoch comes from a ``torch.Generator`` seeded from
(seed, epoch, …), never from state carried across epochs, so a resumed run
samples exactly the batches a continuous run would have.  Steps return
device tensors; the host reads them once per epoch.

Under data parallelism (JAX ``fit(shard_fn=, batch_multiple=)``) every rank
runs this loop with the same seed, so it draws the same global batches;
batch and test-pool sizes are rounded down to a multiple of the world
size, a packed set's batch goes through ``shard_fn`` (this rank's rows),
a pool shards itself, and a test set smaller than the world size is
scored whole on every rank.  Rank 0 alone logs and writes checkpoints: the
other ranks get no logger and a ``CheckpointManager(writer=False)``.
"""

from __future__ import annotations

import functools
import glob
import itertools
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
from meg_decoding_tpu_torch.train.graph import GraphedStep, state_tensors
from meg_decoding_tpu_torch.train.steps import EvalStep
from meg_decoding_tpu_torch.utils.logging import RunLogger
from meg_decoding_tpu_torch.utils.profiling import (
    StepTimer,
    profile_trace,
    span,
)

__all__ = ["fit", "fit_scan", "steps_per_epoch", "resume_if_requested",
           "derived_generator", "train_route", "eval_route"]

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


def train_route(train_step, state) -> Callable:
    """The train step as ``fit`` runs it, ``step(*args, **kw) → metrics``:
    ``train_step.prepare(state, *args, **kw)`` on the host, then a replay
    of one ``GraphedStep`` of its body, captured at the first call (under
    ``train_step.mesh`` with its collectives).  Each call is a
    ``train.step`` span (``step=`` the call's number), the host draws its
    child ``train.prepare`` (``utils/profiling.py``)."""
    graphed = GraphedStep(train_step.body, state, mesh=train_step.mesh)
    calls = itertools.count()

    def step(*args, **kw):
        with span("train.step", "step", next(calls)):
            with span("train.prepare"):
                inputs = train_step.prepare(state, *args, **kw)
            return graphed(inputs)

    return step


def eval_route(eval_step, state, sharded: bool | None = None) -> Callable:
    """The test pools' eval step, ``step(X, Y, subject_idxs, temp,
    labels)``: an ``EvalStep`` as its host part then a replay of one
    ``GraphedStep`` of its body (the state's tensors checked unchanged by
    the capture's warm-up; under a mesh the graph holds its collectives);
    any other as it is, eagerly.  ``sharded`` (data parallelism only: the
    pools are this rank's rows, or whole on every rank) is fixed once a
    call by ``_test_sharding`` and bound here, not passed as an input."""
    kw = {} if sharded is None else {"sharded": sharded}
    if not isinstance(eval_step, EvalStep):
        return functools.partial(eval_step, **kw)
    graphed = GraphedStep(functools.partial(eval_step.body, **kw),
                          device=state.step.device,
                          reads=state_tensors(state), mesh=eval_step.mesh)
    return lambda *args: graphed(eval_step.prepare(*args))


def _eval_test_pools(cfg, test_set, eval_step, state, test_size: int,
                     seed: int, epoch: int, with_labels: bool,
                     shard_fn: Callable | None = None) -> dict:
    """Epoch test pass: every pool of ``test_size`` segments of the shuffled
    test split is scored and the metrics averaged (``test_sweep: false``
    scores one pool, as the reference does).  A ``PackedDataset`` pool is a
    plain gather (then ``shard_fn``'s rows of it); any other draws its
    sessions from a derived generator (a session-sharded pool gives this
    rank's rows itself).  A host-resident pool's batch is copied to the
    state's device.  ``eval_step`` is ``eval_route``'s."""
    n = len(test_set)
    dev = state.step.device
    perm = torch.randperm(n, generator=derived_generator(seed, epoch, _TEST)).numpy()
    sweep = bool(cfg.get("test_sweep", True))
    hist = []
    for j, s in enumerate(_test_pool_starts(n, test_size, sweep)):
        idx = perm[s:s + test_size]
        if isinstance(test_set, PackedDataset):
            batch = test_set.gather(idx)
            if shard_fn is not None:
                batch = shard_fn(batch)
        else:
            batch = test_set.gather(
                idx, generator=derived_generator(seed, epoch, _TEST, j + 1))
        batch = to_device(batch, dev)
        labels = batch[3] if with_labels else None
        m, _ = eval_step(*batch[:3], state.temp.detach(), labels)
        hist.append(m)
    return _mean_metrics(hist)


def _round(n: int, multiple: int) -> int:
    """``n`` rounded down to a multiple of ``multiple``, at least one."""
    return max((n // multiple) * multiple, multiple)


def _test_sharding(test_size: int, batch_multiple: int):
    """``(test_size, sharded)``: the pool size rounded down to a multiple of
    the world size, sharded; or, for a test set too small for that, the
    pool whole on every rank (JAX ``train/loop.py:129-133``).  ``sharded``
    is None on one device."""
    if batch_multiple == 1:
        return test_size, None
    if test_size // batch_multiple > 0:
        return (test_size // batch_multiple) * batch_multiple, True
    return test_size, False


def fit(cfg, train_set, test_set, state, train_step: Callable,
        eval_step: Callable, logger: RunLogger | None,
        ckpt: CheckpointManager | None = None, seed: int = 0,
        start_epoch: int = 0, with_labels: bool = False,
        shard_fn: Callable | None = None, batch_multiple: int = 1):
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

    ``train_step`` is a ``TrainStep``: each step is its host draws then a
    replay of one ``GraphedStep`` of its body, captured at the first step
    of this call (under ``train_step.mesh`` with its collectives); the
    metrics are the replay's copies.  An ``EvalStep`` scores the test
    pools through one graph of its body, captured at the first pool of
    this call.

    A ``train_set`` with ``host_resident`` gathers on the host, and its
    batches reach the state's device through ``prefetch_to_device`` with
    ``cfg.prefetch`` batches in flight (2 by default; 0 copies each batch
    in the loop).  With ``cfg.profile_dir`` the train steps of epoch
    ``cfg.profile_epoch`` (1 by default, as JAX) are traced into it.

    Data parallelism: ``batch_multiple`` is the world size (batch and pool
    sizes are rounded down to multiples of it) and ``shard_fn`` takes this
    rank's rows of a packed set's batch (a pool shards itself); ``logger``
    is None on every rank but 0."""
    epochs = int(cfg.epochs)
    batch_size = _round(min(int(cfg.batch_size), len(train_set)), batch_multiple)
    use_sampler = bool(cfg.get("use_sampler", True))
    updates = int(cfg.get("updates", max(len(train_set) // batch_size, 1)))
    test_size, sharded = _test_sharding(
        min(len(test_set), int(cfg.get("test_size", batch_size))), batch_multiple)
    best_top10, best_metrics = -1.0, {}
    timer = StepTimer({"data.gather": "gather", "train.step": "step"})
    packed = isinstance(train_set, PackedDataset)
    dev = state.step.device
    host_resident = bool(getattr(train_set, "host_resident", False))
    prefetch_n = int(cfg.get("prefetch", 2 if host_resident else 0) or 0)
    profile_dir = cfg.get("profile_dir")
    profile_epoch = int(cfg.get("profile_epoch", 1)) if profile_dir else -1
    step = train_route(train_step, state)
    eval_step = eval_route(eval_step, state, sharded)

    for epoch in range(start_epoch, epochs):
        egen = derived_generator(seed, epoch, _SAMPLE)
        if use_sampler:
            idx_epoch = sample_with_replacement(egen, len(train_set), updates,
                                                batch_size)
        else:
            idx_epoch = shuffle_batches(egen, len(train_set), batch_size)

        def gathered_batches(epoch=epoch, idx_epoch=idx_epoch):
            for step_i, idx in enumerate(idx_epoch):
                if packed:
                    batch = train_set.gather(idx)[:4 if with_labels else 3]
                    if shard_fn is not None:
                        batch = shard_fn(batch)
                else:
                    batch = train_set.gather(
                        idx, generator=derived_generator(
                            seed, epoch, _GATHER, step_i))
                yield batch

        train_hist = []
        # the gathers (also on the prefetch's thread) and the steps are
        # timed by their spans
        with timer:
            if prefetch_n > 0:
                batch_iter = prefetch_to_device(gathered_batches(),
                                                size=prefetch_n, device=dev)
            elif host_resident:
                batch_iter = (to_device(b, dev) for b in gathered_batches())
            else:
                batch_iter = gathered_batches()
            with profile_trace(profile_dir if epoch == profile_epoch
                               else None):
                for batch in batch_iter:
                    train_hist.append(step(*batch))

        tm = _mean_metrics(train_hist)
        best_top10, best_metrics = _end_epoch(
            cfg, test_set, eval_step, state, test_size, seed, epoch,
            with_labels, tm, timer.means_ms(), logger, ckpt, best_top10,
            best_metrics, shard_fn if sharded else None)
        timer.reset()

    return state, best_metrics


def _end_epoch(cfg, test_set, eval_step, state, test_size: int, seed: int,
               epoch: int, with_labels: bool, tm: dict, extra: dict,
               logger: RunLogger | None, ckpt: CheckpointManager | None,
               best_top10: float, best_metrics: dict,
               shard_fn: Callable | None = None):
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
                                    test_size, seed, epoch, with_labels,
                                    shard_fn)
    em = {f"test_{k}": float(v) for k, v in test_metrics.items()}
    row = {"epoch": epoch, **{f"train_{k}": v for k, v in tm.items()},
           **em, **extra}
    if logger is not None:
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
             eval_step: Callable, logger: RunLogger | None,
             ckpt: CheckpointManager | None = None, seed: int = 0,
             start_epoch: int = 0, batch_multiple: int = 1,
             shard_fn: Callable | None = None):
    """Epoch driver over a whole-epoch form (``train/scan_loop.py``): one
    ``scan_epoch(state, generator)`` call an epoch, its generator on the
    state's device seeded from (seed, epoch), the metrics read once, then
    the test pools (through one eval graph, as in ``fit``), the log and
    the checkpoints as in ``fit`` (and its aborts).  ``batch_multiple`` and ``shard_fn`` as in ``fit`` (the test
    pools).  Returns ``(state, best_metrics)``."""
    epochs = int(cfg.epochs)
    test_size, sharded = _test_sharding(
        min(len(test_set), int(cfg.get("test_size", cfg.batch_size))),
        batch_multiple)
    dev = state.step.device
    best_top10, best_metrics = -1.0, {}
    eval_step = eval_route(eval_step, state, sharded)
    for epoch in range(start_epoch, epochs):
        state, means = scan_epoch(
            state, derived_generator(seed, epoch, _SAMPLE, device=dev))
        tm = {k: float(v) for k, v in means.items()}
        best_top10, best_metrics = _end_epoch(
            cfg, test_set, eval_step, state, test_size, seed, epoch, False,
            tm, {}, logger, ckpt, best_top10, best_metrics,
            shard_fn if sharded else None)
    return state, best_metrics


def steps_per_epoch(cfg, n_train: int, batch_multiple: int = 1) -> int:
    """Update steps per epoch, matching ``fit``'s batching: the fixed
    ``updates`` with ``use_sampler``, else ``n_train // batch_size`` (the
    batch rounded down to a multiple of ``batch_multiple``)."""
    bs = _round(max(min(int(cfg.batch_size), n_train), 1), batch_multiple)
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
