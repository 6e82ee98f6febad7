"""GOD (MEG→image) contrastive / regression / classification trainer on one
device.  Port of ``run`` from ``meg_decoding_tpu/cli/train_god.py``.

Covers the reference entry points that share the GOD skeleton (SURVEY
§2.9): ``train_wowandb.py`` (given train/val splits),
``train_wowandb_cv.py`` (fixed-index CV split),
``train_wowandb_cv_contrastive.py`` (+ SameLabelLoss),
``train_wowandb_cv_regression.py`` (MSE), ``train_regression.py`` (+ L2)
and ``train_my_classifier.py`` (gallery classification loss), selected by
config: ``training_mode: cv|split``, ``loss.kind``,
``loss.same_label_weight``, ``l2_weight``, ``criterion``.

The dataset is built on the device (``data/god.py``) and ``fit`` drives
the per-step form: gather → collate → encoder → loss → gradients → Adam;
with ``use_scan_epochs`` and a loss without labels, ``fit_scan`` drives
the whole-epoch form (``train/scan_loop.py:make_scan_epoch``).  Every model
of the zoo trains here: ``brain_encoder``, ``brain_endcoder_seq2static``
(with a window of T ≥ 31 samples), ``eegnet``, ``eegnet_sub`` and
``linear``.
Writes ``{save_root}/runs/<run>/metrics.jsonl`` and ``config.yaml``, and
``{save_root}/ckpt/model_last.pt`` / ``model_best.pt`` (``resume=true``
continues from model_last).

``host_resident: true`` spills the train split to host memory
(``PackedDataset.to_host``) and ``fit`` streams its batches to the card
through the prefetch (``prefetch: N``, 2 by default), as JAX
``cli/train_god.py:82-85``; the whole-epoch form is then not taken.
``use_wandb: true`` logs to wandb as well when the module and its
credentials are there, else to the JSONL alone (``utils/logging.py``).

Data parallelism (JAX ``:61``, ``:88-91``, ``:121-170``): under a process
group — a ``distributed:`` block, torchrun, or the processes this CLI
starts itself, one a GPU, when more than one GPU is visible — every rank
builds the whole GOD set (GOD-sized sets have
nothing to shard) and trains on its rows of each global batch, per step
or in the whole-epoch form (``parallel/dp.py``).  Rank 0 alone writes the
log and the checkpoints.

Run: ``python -m meg_decoding_tpu_torch.cli.train_god
[--config-path configs] [--config-name config_GOD] [--device cuda]
key=value …``, or ``torchrun --nproc_per_node=N -m
meg_decoding_tpu_torch.cli.train_god …``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.cli.evaluate_speech import collate_config
from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.roi import roi
from meg_decoding_tpu_torch.data.sampling import god_cv_split
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.objectives.retrieval import cosine_similarity_matrix
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
from meg_decoding_tpu_torch.train.scan_loop import make_scan_epoch
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import (
    LossConfig,
    make_eval_step,
    make_train_step,
)
from meg_decoding_tpu_torch.utils.logging import RunLogger

__all__ = ["run"]


def _loss_config(cfg) -> LossConfig:
    return LossConfig(
        kind=cfg.select("loss.kind", "clip"),
        reduction=cfg.get("reduction", "mean"),
        same_label_weight=float(cfg.select("loss.same_label_weight", 0.0)),
        l2_weight=float(cfg.get("l2_weight", 0.0)),
        criterion=cfg.get("criterion", "crossentropy"),
        smooth_value=float(cfg.get("smooth_value", 0.1)),
        label_offset=1,  # GOD vec_index is 1-indexed (loss.py:191)
        temp_trainable=bool(cfg.get("temp_trainable", True)),
        clip_impl=str(cfg.select("loss.clip_impl", "factored")))


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    """Train per ``cfg``; returns the epoch row with the best test top-10."""
    dev = maybe_distributed_init(cfg, resolve_device(device))
    mesh, shard_fn, replicate_fn = setup_data_parallel(cfg, dev)
    n = 1 if mesh is None else mesh.world_size
    writer = mesh is None or mesh.rank == 0
    seed = int(cfg.get("seed", 0))
    save_root = cfg.get("save_root", "runs_out")
    os.makedirs(save_root, exist_ok=True)

    source = build_god_dataset(cfg, "train", device=dev)
    if cfg.get("training_mode", "cv") == "cv":
        # fixed-index CV split over the packed epochs (train_wowandb_cv.py:145-148)
        n_per = int(cfg.get("epochs_per_subject",
                            len(source) // max(source.num_subjects, 1)))
        frac = cfg.get("cv_train_per_subject")
        start = int(frac) if frac is not None else int(round(n_per * 5 / 6))
        ind_tr, ind_te = god_cv_split(n_per, source.num_subjects, start)
        train_set, test_set = source.subset(ind_tr), source.subset(ind_te)
    else:  # 'split': the separate val sessions (train_wowandb.py)
        train_set = source
        test_set = build_god_dataset(
            cfg, "val", mean_X=source.mean_X, std_X=source.std_X,
            mean_Y=source.mean_Y, std_Y=source.std_Y, device=dev)
    cfg.num_subjects = source.num_subjects
    if cfg.get("host_resident", False):
        # the spill path: the train epochs stay in host memory and stream
        # through the prefetch (train/loop.py)
        train_set = train_set.to_host()

    roi_channels = roi(cfg)
    model = get_model(cfg, ch_locations_2d(cfg, roi_channels), device=dev,
                      seed=seed, num_channels=len(roi_channels))
    loss_cfg = _loss_config(cfg)
    collate_cfg = collate_config(cfg)
    gallery = gallery_self_sim = None
    with_labels = loss_cfg.kind == "classification" or loss_cfg.same_label_weight > 0
    if loss_cfg.kind == "classification":
        gallery = torch.from_numpy(
            np.load(cfg.image_features_train_path).astype(np.float32)).to(dev)
        if loss_cfg.criterion == "similarity_crossentropy":
            gallery_self_sim = cosine_similarity_matrix(gallery, gallery)

    updates = int(cfg.get("updates", 1200))
    # the schedule counts `updates` steps as an epoch, also with
    # use_sampler: false, as the JAX trainer does (cli/train_god.py:114-115)
    optimizer = make_optimizer(cfg, updates)
    state = replicate_fn(create_train_state(
        model, optimizer,
        init_temperature=float(cfg.get("init_temperature", 5.1)), seed=seed))
    train_step = make_train_step(model, optimizer, loss_cfg, collate_cfg,
                                 gallery=gallery, gallery_self_sim=gallery_self_sim,
                                 mesh=mesh)
    eval_step = make_eval_step(model, loss_cfg, collate_cfg, gallery=gallery,
                               gallery_self_sim=gallery_self_sim, mesh=mesh)

    logger = None
    if writer:
        logger = RunLogger(save_root, run_name=cfg.get("run_name"),
                           use_wandb=bool(cfg.get("use_wandb", False)),
                           wandb_cfg=cfg.get("wandb"))
        logger.dump_config(cfg)
    ckpt = CheckpointManager(os.path.join(save_root, "ckpt"), writer=writer)
    state, start_epoch = resume_if_requested(
        cfg, ckpt, state, save_root, steps_per_epoch(cfg, len(train_set), n))
    if (cfg.get("use_scan_epochs", False) and not with_labels
            and not cfg.get("host_resident", False)):
        # the whole-epoch form; the label losses and the spill path take
        # the per-step driver
        scan_epoch = make_scan_epoch(model, optimizer, loss_cfg, collate_cfg,
                                     train_set, updates=updates,
                                     batch_size=max(int(cfg.batch_size) // n * n, n),
                                     mesh=mesh)
        _, best = fit_scan(cfg, train_set, test_set, state, scan_epoch,
                           eval_step, logger, ckpt, seed=seed,
                           start_epoch=start_epoch, batch_multiple=n,
                           shard_fn=shard_fn)
        return best
    _, best = fit(cfg, train_set, test_set, state, train_step, eval_step,
                  logger, ckpt, seed=seed, start_epoch=start_epoch,
                  with_labels=with_labels, shard_fn=shard_fn,
                  batch_multiple=n)
    return best


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-path", default="configs")
    ap.add_argument("--config-name", default="config_GOD")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    cfg = compose(args.config_path, args.config_name, args.overrides)
    return run_cli("meg_decoding_tpu_torch.cli.train_god", args, cfg, run)


if __name__ == "__main__":
    main()
