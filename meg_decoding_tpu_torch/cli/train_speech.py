"""Speech-decoding trainer, Gwilliams2022 and Brennan2018 on one device.
Port of ``run`` from ``meg_decoding_tpu/cli/train_speech.py``.  Gwilliams
runs the fused gather + train step (``train/scan_loop.py``) driven by
``fit``, or, with ``use_scan_epochs`` on a sentence/deep split, the
whole-epoch form driven by ``fit_scan``; either with the cached collate
statistics (``cache_collate_stats``, as the speed presets
``configs/throughput*.yaml`` set it).  Brennan, and Gwilliams with
``fuse_gather: false``, run the unfused step: the pool gathers the batch,
then ``make_train_step`` (no collate for Brennan: its segments were scaled
when the dataset was built).

Reference: ``train.py`` — builds the dataset per ``split_mode``
(sentence/shallow/deep, :57-90), per-batch Adam updates, a test pass and
model_last each epoch.  It reads the same YAML configs; the data source is
a reference-format preprocessed cache (``cfg.cache_dir``, or the first
cache under ``{root_dir}/data/Gwilliams2022/preprocessed``), or for
Brennan the raw EEG under ``{root_dir}/data/Brennan2018/raw`` and the
embedding stream at ``y_embeds_path`` (default
``{root_dir}/data/Brennan2018/Y_embeds/embd_wav2vec.npy``; when it does not
exist, the audio under ``{root_dir}/data/Brennan2018/audio`` is embedded
with wav2vec2 and the stream saved there, as in JAX
``cli/train_speech.py:199-205``).

Writes ``{save_root}/runs/<run>/metrics.jsonl`` and ``config.yaml``, and
``{save_root}/ckpt/model_last.pt`` / ``model_best.pt`` (the full train
state; ``resume=true`` continues from model_last).

``host_resident: true`` spills both splits to host memory (through one
buffer cache, so that splits sharing a tensor share its host copy) and
forces ``fuse_gather: false`` and ``use_scan_epochs: false``: the batches
are gathered on the host and streamed to the card by ``fit``'s prefetch
(``prefetch: N``, 2 by default), as JAX ``cli/train_speech.py:271-290``.
``use_wandb: true`` logs to wandb as well when the module and its
credentials are there, else to the JSONL alone (``utils/logging.py``).

Data parallelism (JAX ``:261``, ``:295-357``, ``:419-443``): under a
process group — a ``distributed:`` block, torchrun, or the processes this
CLI starts itself, one a GPU, when more than one GPU is visible — every
rank trains on its rows of each global batch (``parallel/dp.py``).  A
Gwilliams split is built on the host and
session-sharded onto the ranks (``shard_gwilliams_splits``); a spilled one
stays on the host and replays the sharded run's session draw; Brennan is
built whole on every rank and sharded by rows.  Rank 0 alone writes the
log and the checkpoints; every rank reads a resume.

Run: ``python -m meg_decoding_tpu_torch.cli.train_speech
[--config-path configs] [--config-name config] [--device cuda]
key=value …``, or ``torchrun --nproc_per_node=N -m
meg_decoding_tpu_torch.cli.train_speech …``.
"""

from __future__ import annotations

import argparse
import os

import torch

from meg_decoding_tpu_torch.cli.evaluate_speech import (
    collate_config,
    load_speech_splits,
)
from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.gwilliams import GwilliamsPacked, to_host
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.parallel.dp import (
    maybe_distributed_init,
    run_cli,
    setup_data_parallel,
)
from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
from meg_decoding_tpu_torch.train.loop import (
    fit,
    fit_scan,
    resume_if_requested,
    steps_per_epoch,
)
from meg_decoding_tpu_torch.train.scan_loop import (
    make_fused_speech_step,
    make_gwilliams_scan_epoch,
    shard_gwilliams_splits,
)
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import (
    LossConfig,
    make_eval_step,
    make_train_step,
)
from meg_decoding_tpu_torch.utils.logging import RunLogger

__all__ = ["run", "loss_config", "spill_speech_splits"]


def _check_dataset(cfg) -> None:
    if cfg.dataset not in ("Gwilliams2022", "Brennan2018"):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not a speech dataset "
            "(Gwilliams2022, Brennan2018)")


class _FusedPool:
    """A pool for the fused step, as JAX's ``_FusedLoader``: its gather
    gives the segment ids and the generator, and the step draws the
    sessions and gathers the batch itself."""

    def __init__(self, pool):
        self.pool = pool

    def __len__(self):
        return len(self.pool)

    def gather(self, idx, generator: torch.Generator):
        return self.pool.segment_ids(idx), generator


def spill_speech_splits(train_set, test_set) -> None:
    """Move both pools' packed splits to host memory, in place: shallow
    pools wrap one packed object, sentence and deep splits share the
    recordings and streams across two, so the spill goes through one
    buffer cache and each tensor is copied to the host once.  Both are
    spilled before either is replaced, so that the cache's keys (the
    sources' storages) stay alive meanwhile."""
    shared = test_set.ds is train_set.ds
    cache = {}
    spill = ((lambda d: to_host(d, cache)) if isinstance(train_set.ds, GwilliamsPacked)
             else lambda d: d.to_host())
    train_host = spill(train_set.ds)
    test_host = train_host if shared else spill(test_set.ds)
    train_set.ds, test_set.ds = train_host, test_host


def loss_config(cfg) -> LossConfig:
    return LossConfig(kind=cfg.select("loss.kind", "clip"),
                      reduction=cfg.get("reduction", "mean"),
                      clip_impl=str(cfg.select("loss.clip_impl", "factored")),
                      temp_trainable=bool(cfg.get("temp_trainable", True)))


def shard_speech_splits(mesh, train_set, test_set) -> None:
    """Session-shard both pools' Gwilliams splits onto this rank, in place
    (a shallow pair wraps one split; sentence and deep splits share their
    recordings, sharded once), and give both pools the mesh."""
    if (isinstance(train_set.ds, GwilliamsPacked)
            and not train_set.ds.host_resident):
        if test_set.ds is train_set.ds:
            train_set.ds = test_set.ds = shard_gwilliams_splits(mesh, train_set.ds)[0]
        else:
            train_set.ds, test_set.ds = shard_gwilliams_splits(
                mesh, train_set.ds, test_set.ds)
    train_set.mesh = test_set.mesh = mesh


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    """Train per ``cfg``; returns the epoch row with the best test top-10."""
    _check_dataset(cfg)
    dev = maybe_distributed_init(cfg, resolve_device(device))
    mesh, _, replicate_fn = setup_data_parallel(cfg, dev)
    n = 1 if mesh is None else mesh.world_size
    writer = mesh is None or mesh.rank == 0
    seed = int(cfg.get("seed", 0))
    save_root = cfg.get("save_root", "runs_out")
    os.makedirs(save_root, exist_ok=True)

    gwilliams = cfg.dataset == "Gwilliams2022"
    # under a mesh a Gwilliams split is built on the host and only each
    # rank's session shard goes to its device
    train_set, test_set = load_speech_splits(
        cfg, seed, "cpu" if mesh is not None and gwilliams else dev)
    cfg.num_subjects = train_set.num_subjects
    if cfg.get("host_resident", False):
        spill_speech_splits(train_set, test_set)
        cfg.fuse_gather = False
        cfg.use_scan_epochs = False
    cfg.num_channels = train_set.num_channels
    model = get_model(cfg, ch_locations_2d(cfg), device=dev, seed=seed,
                      num_channels=cfg.num_channels)
    collate_cfg = collate_config(cfg)
    loss_cfg = loss_config(cfg)
    updates = int(cfg.get("updates", 1200))
    # the schedule counts `updates` steps as an epoch, also with
    # use_sampler: false, as the JAX trainer does (cli/train_speech.py:323)
    optimizer = make_optimizer(cfg, updates)
    state = replicate_fn(create_train_state(
        model, optimizer,
        init_temperature=float(cfg.get("init_temperature", 5.1)), seed=seed))
    if mesh is not None:
        shard_speech_splits(mesh, train_set, test_set)
    cache_stats = bool(cfg.get("cache_collate_stats", False))
    eval_step = make_eval_step(model, loss_cfg, collate_cfg, mesh=mesh)

    logger = None
    if writer:
        logger = RunLogger(save_root, run_name=cfg.get("run_name"),
                           use_wandb=bool(cfg.get("use_wandb", False)),
                           wandb_cfg=cfg.get("wandb"))
        logger.dump_config(cfg)
    ckpt = CheckpointManager(os.path.join(save_root, "ckpt"), writer=writer)
    state, start_epoch = resume_if_requested(
        cfg, ckpt, state, save_root, steps_per_epoch(cfg, len(train_set), n))
    if (gwilliams and cfg.get("use_scan_epochs", False)
            and train_set.indices is None):
        # the whole-epoch form, on a sentence/deep Gwilliams split (the
        # packed set is the training split; a shallow subset and Brennan
        # take the per-step driver)
        scan_epoch = make_gwilliams_scan_epoch(
            model, optimizer, loss_cfg, collate_cfg, train_set.ds,
            updates=updates, batch_size=max(int(cfg.batch_size) // n * n, n),
            cache_collate_stats=cache_stats, mesh=mesh)
        _, best = fit_scan(cfg, train_set, test_set, state, scan_epoch,
                           eval_step, logger, ckpt, seed=seed,
                           start_epoch=start_epoch, batch_multiple=n)
        return best
    if gwilliams and bool(cfg.get("fuse_gather", True)):
        fused = make_fused_speech_step(model, optimizer, loss_cfg,
                                       collate_cfg, train_set.ds,
                                       cache_collate_stats=cache_stats,
                                       mesh=mesh)
        train_set_for_fit = _FusedPool(train_set)
        step = lambda state, seg, gen: fused(state, seg, generator=gen)
    else:
        train_set_for_fit = train_set
        step = make_train_step(model, optimizer, loss_cfg, collate_cfg,
                               mesh=mesh)
    _, best = fit(cfg, train_set_for_fit, test_set, state, step, eval_step,
                  logger, ckpt, seed=seed, start_epoch=start_epoch,
                  batch_multiple=n)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-path", default="configs")
    ap.add_argument("--config-name", default="config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    cfg = compose(args.config_path, args.config_name, args.overrides)
    return run_cli("meg_decoding_tpu_torch.cli.train_speech", args, cfg, run)


if __name__ == "__main__":
    main()
