"""Speech-decoding evaluation from a checkpoint (Gwilliams2022 /
Brennan2018).  Port of ``run`` from ``meg_decoding_tpu/cli/evaluate_speech.py``.

Scores the whole test split in candidate pools of ``test_size`` segments:
segment-retrieval top-1/top-10 and pairwise identification (correlation),
and writes ``{save_root}/eval_results.json``.  It reads the same YAML
configs through the port's ``core/config.py``.  The test split is the
trainer's, from the same seed; Brennan's segments were scaled when the
dataset was built, so they take no collate.

The checkpoint is ``cfg.ckpt_path``, else the first of ``model_best.pt``,
``model_last.pt`` (the train CLI's, as the JAX package prefers best, then
last) and ``model.pt`` under ``{ckpt_dir or save_root/ckpt}``.  It holds
either a state_dict in the port's names (``interop.params_from_jax``
converts flax variables; a ``loss.temp`` entry is allowed) or a full train
state (``train/state.py``), whose parameters are taken.  The JAX package's
orbax checkpoints need JAX to read and are not loaded here.

Run: ``python -m meg_decoding_tpu_torch.cli.evaluate_speech
[--config-path configs] [--config-name config] [--device cuda] key=value …``
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.brennan import (
    BrennanPacked,
    build_brennan_dataset,
    embed_brennan_audio,
)
from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    build_gwilliams_dataset,
    device_major_sessions,
    draw_local_sessions,
    gather_speech_batch,
    load_gwilliams_cache,
)
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.sampling import random_split
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.interop import split_loss_params
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.objectives.retrieval import (
    pairwise_identification,
    retrieval_accuracy,
)
from meg_decoding_tpu_torch.serving.forward import make_serving_forward
from meg_decoding_tpu_torch.train.steps import CollateConfig

__all__ = ["run", "find_gwilliams_cache", "checkpoint_path",
           "load_model_state", "collate_config", "SpeechPool",
           "load_gwilliams_splits", "load_brennan_splits",
           "load_speech_splits"]


class SpeechPool:
    """A packed speech split (or a subset of its segments) with the
    reference's random pairing — a Gwilliams segment with a random
    subject-session, a Brennan chunk with a random subject — drawn from a
    seeded ``torch.Generator``: ``gather(idx) → (X, Y, subject_idxs)``;
    ``gather(idx, generator)`` draws from the given generator instead.

    Under data parallelism (``mesh`` set, JAX ``_SpeechLoader``'s mesh
    branch, ``cli/train_speech.py:70-140``) ``idx`` is a global batch, the
    same on every rank, and the draw is the global batch's.  A batch that
    divides the world size gives this rank's rows: gathered from its
    session shard (a session-sharded Gwilliams split), cut on the host
    with the sharded run's device-major session draw (a spilled split,
    ``device_major_sessions``), or a Brennan batch's rows.  Another batch
    (a test set smaller than the world size, a direct call) is padded
    cyclically to a multiple, gathered so, and given whole on every rank,
    trimmed."""

    def __init__(self, ds: GwilliamsPacked | BrennanPacked, indices=None,
                 seed: int = 0):
        self.ds = ds
        self.indices = None if indices is None else np.asarray(indices)
        self.generator = torch.Generator().manual_seed(int(seed))
        self.num_subjects = ds.num_subjects
        self.mesh = None
        self._sharded_gather = None

    def __len__(self):
        return len(self.ds) if self.indices is None else len(self.indices)

    @property
    def num_channels(self) -> int:
        """The channels of a gathered batch."""
        return self.ds.num_channels

    @property
    def host_resident(self) -> bool:
        """The split lives in host memory: ``fit`` streams its batches
        through the prefetch (``train/loop.py``)."""
        return bool(getattr(self.ds, "host_resident", False))

    def segment_ids(self, idx) -> np.ndarray:
        """Pool positions → global segment ids of ``ds``."""
        return np.asarray(idx) if self.indices is None \
            else self.indices[np.asarray(idx)]

    def gather(self, idx, generator: torch.Generator | None = None):
        gen = self.generator if generator is None else generator
        if self.mesh is not None:
            return self._gather_dp(self.segment_ids(idx), gen)
        X, Y, subs, _ = self.ds.gather(self.segment_ids(idx), generator=gen)
        return X, Y, subs

    def _gather_dp(self, ids: np.ndarray, gen: torch.Generator):
        mesh, m = self.mesh, len(ids)
        n = mesh.world_size
        whole = m % n != 0
        ids = np.resize(ids, m + (-m) % n)
        b = len(ids) // n
        mine = slice(mesh.rank * b, (mesh.rank + 1) * b)
        if isinstance(self.ds, GwilliamsPacked) and self.ds.session_shard:
            if self._sharded_gather is None:
                from meg_decoding_tpu_torch.train.scan_loop import (
                    _make_sharded_gather,
                )

                self._sharded_gather = _make_sharded_gather(mesh, self.ds)
            out = self._sharded_gather(ids, draw_local_sessions(
                gen, len(ids), n, len(self.ds.session_subject)))
            if whole:
                return tuple(mesh.all_gather(t)[:m] for t in out)
            return out
        if isinstance(self.ds, GwilliamsPacked) and whole:
            # spilled: the sharded run's sessions, cut on the host
            X, Y, subs, _ = gather_speech_batch(self.ds, ids, generator=gen,
                                                device_major=n)
        elif isinstance(self.ds, GwilliamsPacked):
            S = self.ds.num_sessions
            sess = device_major_sessions(draw_local_sessions(gen, len(ids), n, S),
                                         n, S)
            X, Y, subs, _ = gather_speech_batch(self.ds, ids[mine],
                                                sess_ids=sess[mine])
        else:
            X, Y, subs, _ = self.ds.gather(ids, generator=gen)
            if not whole:
                X, Y, subs = X[mine], Y[mine], subs[mine]
        return (X[:m], Y[:m], subs[:m]) if whole else (X, Y, subs)


def find_gwilliams_cache(cfg) -> str:
    """``cfg.cache_dir`` if set, else the first dir under
    ``{root_dir}/data/Gwilliams2022/preprocessed`` holding an ``x_dict.npy``.
    Records the result on ``cfg.cache_dir`` (``ch_locations_2d`` reads a
    cache-resident ``layout.npy`` from there)."""
    cache_dir = cfg.get("cache_dir")
    if cache_dir is None:
        base = os.path.join(cfg.get("root_dir", "."), "data", "Gwilliams2022",
                            "preprocessed")
        cands = sorted(os.listdir(base)) if os.path.isdir(base) else []
        for c in cands:
            if os.path.exists(os.path.join(base, c, "x_dict.npy")):
                cache_dir = os.path.join(base, c)
                break
    if cache_dir is None:
        raise FileNotFoundError(
            "No Gwilliams preprocessed cache found: point cfg.cache_dir at a "
            "reference-format cache (x_dict.npy, y_dict.npy, onset tables)")
    cfg.cache_dir = cache_dir
    return cache_dir


def load_gwilliams_splits(cfg, seed: int, device) -> tuple[SpeechPool, SpeechPool]:
    """The (train, test) pools of the trainer: sentence/deep splits from the
    packer, shallow by ``random_split`` over segments of one packed set."""
    x, y, meg_on, sp_on, sent = load_gwilliams_cache(find_gwilliams_cache(cfg))
    split_mode = cfg.get("split_mode", "shallow")
    packed = build_gwilliams_dataset(cfg, x, y, meg_on, sp_on, sent,
                                     split_mode=split_mode, seed=seed,
                                     device=device)
    if split_mode in ("sentence", "deep"):
        return (SpeechPool(packed[0], seed=seed),
                SpeechPool(packed[1], seed=seed + 1))
    tr, te = random_split(torch.Generator().manual_seed(seed), len(packed),
                          float(cfg.split_ratio))
    return SpeechPool(packed, tr, seed=seed), SpeechPool(packed, te, seed=seed + 1)


def load_brennan_splits(cfg, seed: int, device) -> tuple[SpeechPool, SpeechPool]:
    """The (train, test) pools of the trainer: the dataset built from the
    raw EEG under ``{root_dir}/data/Brennan2018/raw`` and the embedding
    stream at ``y_embeds_path`` (embedded from the audio and saved there
    when it does not exist: ``data/brennan.py:embed_brennan_audio``), then
    ``random_split`` over its chunks."""
    root = cfg.get("root_dir", ".")
    y_path = (cfg.get("y_embeds_path")
              or f"{root}/data/Brennan2018/Y_embeds/embd_wav2vec.npy")
    if os.path.exists(y_path):
        Y_stream = np.load(y_path)
    else:
        Y_stream = embed_brennan_audio(cfg, y_path, device=device)
    packed = build_brennan_dataset(cfg, Y_stream, device=device)
    tr, te = random_split(torch.Generator().manual_seed(seed), len(packed),
                          float(cfg.split_ratio))
    return (SpeechPool(packed.subset(tr), seed=seed),
            SpeechPool(packed.subset(te), seed=seed + 1))


def load_speech_splits(cfg, seed: int, device) -> tuple[SpeechPool, SpeechPool]:
    """The (train, test) pools of ``cfg.dataset``."""
    if cfg.dataset == "Brennan2018":
        return load_brennan_splits(cfg, seed, device)
    return load_gwilliams_splits(cfg, seed, device)


def checkpoint_path(cfg) -> str:
    if cfg.get("ckpt_path"):
        return cfg.ckpt_path
    ckpt_dir = cfg.get("ckpt_dir") or os.path.join(
        cfg.get("save_root", "runs_out"), "ckpt")
    paths = [os.path.join(ckpt_dir, f"{n}.pt")
             for n in ("model_best", "model_last", "model")]
    return next((p for p in paths if os.path.exists(p)), paths[-1])


def load_model_state(path: str, device) -> dict:
    """The encoder's state_dict from a checkpoint file: a state_dict, or
    the ``params`` of a saved train state; ``loss.*`` entries dropped."""
    sd = torch.load(path, map_location=device, weights_only=True)
    if "params" in sd and "opt" in sd:  # TrainState.state_dict()
        sd = sd["params"]
    return split_loss_params(sd)[0]


def collate_config(cfg) -> CollateConfig:
    """The collate the trainer applied, from ``cfg.preprocs`` (no baseline
    without a resample rate, as GOD's config allows).  Off for Brennan,
    which scales and baseline-corrects when the dataset is built (JAX
    ``cli/train_speech.py:310-315``)."""
    rate = float(cfg.preprocs.get("brain_resample_rate") or 0)
    return CollateConfig(
        baseline_len_samp=int(rate * float(cfg.preprocs.get("baseline_len_sec", 0))),
        clamp_lim=float(cfg.preprocs.get("clamp_lim", 20)),
        clamp=bool(cfg.preprocs.get("clamp", True)),
        enabled=cfg.dataset != "Brennan2018")


def run(cfg: Config, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    if cfg.dataset not in ("Gwilliams2022", "Brennan2018"):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not a speech dataset "
            "(Gwilliams2022, Brennan2018)")
    seed = int(cfg.get("seed", 0))
    save_root = cfg.get("save_root", "runs_out")
    test_set = load_speech_splits(cfg, seed, dev)[1]
    cfg.num_subjects = test_set.num_subjects
    cfg.num_channels = test_set.num_channels
    model = get_model(cfg, ch_locations_2d(cfg), device=dev, seed=seed,
                      num_channels=cfg.num_channels)

    path = checkpoint_path(cfg)
    model.load_state_dict(load_model_state(path, dev))
    print(f"loaded checkpoint: {path}")
    forward = make_serving_forward(collate_config(cfg))

    # score the whole test split in candidate pools of `test_size` segments;
    # the final pool overlaps backwards to keep every pool full
    pool = min(len(test_set), int(cfg.get("test_size", cfg.batch_size)))
    n_pools = max(-(-len(test_set) // pool), 1)
    top1s, top10s, pids = [], [], []
    for p in range(n_pools):
        start = min(p * pool, len(test_set) - pool)
        X, Y, subs = test_set.gather(np.arange(start, start + pool))
        Z = forward(model, X, subs)
        acc = retrieval_accuracy(Z, Y, top_ks=(1, 10))
        top1s.append(float(acc["top1"]))
        top10s.append(float(acc["top10"]))
        pids.append(float(pairwise_identification(
            Z, Y, metric="correlation").mean()))

    results = {
        "test_top1": float(np.mean(top1s)),
        "test_top10": float(np.mean(top10s)),
        "pairwise_correlation": float(np.mean(pids)),
        "pool_size": pool,
        "n_pools": n_pools,
        "n_test_segments": len(test_set),
    }
    os.makedirs(save_root, exist_ok=True)
    with open(os.path.join(save_root, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


def main(argv=None) -> dict:
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
