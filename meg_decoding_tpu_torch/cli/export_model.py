"""Export a trained checkpoint as a serving artifact.  Port of
``meg_decoding_tpu/cli/export_model.py``.

Rebuilds the model as the port's evaluators do (``cli/evaluate_speech.py``,
``cli/evaluate_god.py``), restores ``model_best`` (else ``model_last``)
from ``{ckpt_dir or save_root/ckpt}``, and writes a batch-polymorphic
``torch.export`` artifact of the collate chain and the encoder to
``{export_dir or save_root/export}`` (``serving/export.py``).  The
program is traced on ``--device`` and runs on the card and on the CPU
(``serving/export.py:load_artifact``).

Run: ``python -m meg_decoding_tpu_torch.cli.export_model
[--config-path configs] [--config-name config] [--device cuda] key=value …``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.cli.evaluate_speech import (
    collate_config,
    find_gwilliams_cache,
    load_brennan_splits,
    load_model_state,
)
from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.serving.export import save_artifact

__all__ = ["run", "main", "export_checkpoint_path"]


def _gwilliams_export_meta(cfg) -> tuple[int, int, int]:
    """(num_subjects, num_channels, seq_len) without loading the
    recordings onto a device: the subjects from the onset table, the
    channel count from the config, else the cache's ``meta.json``, else
    one recording read on the host (a cache without ``meta.json`` only: it
    loads ``x_dict.npy`` into host memory).  The channel count is the
    data's, not the layout's: a KIT layout can hold more positions than
    recorded channels."""
    from meg_decoding_tpu_torch.data.gwilliams import parse_sessions

    cache_dir = find_gwilliams_cache(cfg)
    meg_on = np.load(os.path.join(cache_dir, "meg_onsets.npy"),
                     allow_pickle=True).item()
    _, subjects = parse_sessions(meg_on.keys())
    rate = float(cfg.preprocs.get("brain_resample_rate"))
    seq_len = int(rate * float(cfg.preprocs.seq_len_sec))
    num_channels = cfg.get("num_channels")
    if not num_channels:
        meta_path = os.path.join(cache_dir, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                num_channels = json.load(f).get("num_channels")
    if not num_channels:
        x = np.load(os.path.join(cache_dir, "x_dict.npy"),
                    allow_pickle=True).item()
        if not x:
            raise ValueError(
                f"cache {cache_dir} holds no recordings: cannot derive the "
                "export's channel count (pass num_channels=… or rebuild the "
                "cache)")
        num_channels = next(iter(x.values())).shape[0]
    return len(subjects), int(num_channels), seq_len


def export_checkpoint_path(cfg) -> tuple[str, str]:
    """(path, name) of ``model_best.pt``, else ``model_last.pt``, under
    ``{ckpt_dir or save_root/ckpt}``."""
    ckpt_dir = cfg.get("ckpt_dir") or os.path.join(
        cfg.get("save_root", "runs_out"), "ckpt")
    for name in ("model_best", "model_last"):
        path = os.path.join(ckpt_dir, f"{name}.pt")
        if os.path.exists(path):
            return path, name
    raise FileNotFoundError(f"no model_best.pt or model_last.pt under {ckpt_dir}")


def run(cfg: Config, device: str | torch.device = "cuda") -> str:
    """Write the artifact of ``cfg``'s checkpoint; returns its directory."""
    dev = resolve_device(device)
    seed = int(cfg.get("seed", 0))
    save_root = cfg.get("save_root", "runs_out")
    out_dir = cfg.get("export_dir") or os.path.join(save_root, "export")

    if cfg.dataset == "GOD":
        from meg_decoding_tpu_torch.data.god import build_god_dataset
        from meg_decoding_tpu_torch.data.roi import roi

        dataset = build_god_dataset(cfg, "train", device=dev)
        cfg.num_subjects = dataset.num_subjects
        roi_channels = roi(cfg)
        loc = ch_locations_2d(cfg, roi_channels)
        num_channels = len(roi_channels)
        seq_len = int(dataset.X.shape[-1])
    elif cfg.dataset == "Gwilliams2022":
        # the shapes from the cache's tables, not from the packed
        # recordings (~9.3 GB at full scale)
        num_subjects, num_channels, seq_len = _gwilliams_export_meta(cfg)
        cfg.num_subjects = num_subjects
        cfg.num_channels = num_channels
        loc = ch_locations_2d(cfg)
    else:
        # Brennan: the effective rate, so seq_len, depends on the data
        # (data/brennan.py), and the EEG is small: build it as the trainer
        train_set = load_brennan_splits(cfg, seed, dev)[0]
        cfg.num_subjects = train_set.num_subjects
        num_channels = cfg.num_channels = train_set.num_channels
        loc = ch_locations_2d(cfg)
        seq_len = int(train_set.ds.X.shape[-1])

    model = get_model(cfg, loc, device=dev, seed=seed,
                      num_channels=num_channels)
    path, which = export_checkpoint_path(cfg)
    model.load_state_dict(load_model_state(path, dev))
    print(f"exporting checkpoint: {which}")
    # the trainers' collate: Gwilliams and GOD scale each batch, Brennan's
    # segments were scaled when the dataset was built
    save_artifact(out_dir, model, num_channels, seq_len, collate_config(cfg),
                  extra_meta={"dataset": str(cfg.dataset), "checkpoint": which,
                              "num_subjects": int(cfg.num_subjects)})
    print(f"serving artifact written to {out_dir}")
    return out_dir


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config-path", default="configs")
    ap.add_argument("--config-name", default="config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    cfg = compose(args.config_path, args.config_name, args.overrides)
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
