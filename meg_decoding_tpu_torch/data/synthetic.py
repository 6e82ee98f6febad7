"""Synthetic datasets in the exact on-disk formats the real builders read:
a Gwilliams2022 cache (``x_dict.npy``/``y_dict.npy``/onset tables —
reference ``gwilliams2022.py:64-109``), GOD sessions (Brainstorm ``.mat``
files — reference ``load_meg.py:12-103``) and Brennan2018 raw EEG
(fieldtrip ``raw`` structs — reference ``brennan2018.py:248-258``) with a
precomputed embedding stream, so every downstream code path is the real
one.

Port of ``make_synthetic_gwilliams_cache``, ``make_synthetic_god_dataset``
and ``make_synthetic_brennan_raw`` from
``meg_decoding_tpu/data/synthetic.py`` (numpy/scipy only; the same seed
writes the same files), plus the full-width set-ups of the on-card smoke
run.  The Gwilliams MEG and Brennan EEG channels are a random linear mix of
the embedding stream plus noise, so contrastive retrieval is learnable.
"""

from __future__ import annotations

import json
import os

import numpy as np
import scipy.io
import torch

from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    build_gwilliams_dataset,
    load_gwilliams_cache,
)
from meg_decoding_tpu_torch.data.layout import synthetic_cap_locations
from meg_decoding_tpu_torch.data.sampling import random_split

__all__ = ["make_synthetic_gwilliams_cache", "make_synthetic_god_dataset",
           "make_synthetic_brennan_raw", "full_width_speech", "full_width_god", "CONFIGS_DIR",
           "FULL_WIDTH_CACHE", "FULL_WIDTH_GOD"]

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")
# 27 subjects at the widths of configs/config.yaml's speech model: C = 208
# sensors, F = 1024 embedding features, 120 Hz; 20 s per recording
FULL_WIDTH_CACHE = dict(n_subjects=27, n_sessions_per=1, C=208, rate=120,
                        rec_sec=20.0, words_per_task=96, F=1024)
# one GOD subject at the dataset's geometry: 203 MEG channels at 1000 Hz,
# 600 train trials (the reference's per-session count, god.py:39) and 50
# val trials, 512-wide CLIP features; F stored as float32 (~0.5 GB a
# train session)
FULL_WIDTH_GOD = dict(num_channels=203, num_roi=22, fs=1000.0, n_train=600,
                      n_test=50, feat_dim=512, meg_dtype=np.float32)


def make_synthetic_gwilliams_cache(cache_dir: str, n_subjects: int = 2,
                                   n_sessions_per: int = 2, C: int = 12,
                                   rate: int = 120, rec_sec: float = 30.0,
                                   words_per_task: int = 24, F: int = 16,
                                   seed: int = 0) -> Config:
    """Write a reference-format Gwilliams preprocessed cache with synthetic
    recordings, embedding streams, and word-onset tables; returns a minimal
    config pointing at it."""
    rng = np.random.RandomState(seed)
    os.makedirs(cache_dir, exist_ok=True)
    T = int(rec_sec * rate)
    x_dict, meg_onsets, speech_onsets, sentence_idxs, y_dict = {}, {}, {}, {}, {}
    for t in range(4):
        task = f"task{t}"
        onsets = np.sort(rng.uniform(0.5, rec_sec - 4.0, words_per_task))
        speech_onsets[task] = onsets
        # one sentence index per word (groups of 4; a remainder forms a
        # final shorter sentence)
        sentence_idxs[task] = np.arange(words_per_task) // 4
        y_dict[task] = rng.randn(F, T).astype(np.float64)
    for s in range(n_subjects):
        for sess in range(n_sessions_per):
            for t in range(4):
                key = f"subject{s+1:02d}_sess{sess}_task{t}"
                task = f"task{t}"
                mix = rng.randn(C, F) * 0.5
                x = mix @ y_dict[task] + 0.1 * rng.randn(C, T)
                x_dict[key] = x.astype(np.float64)
                meg_onsets[key] = speech_onsets[task]  # same alignment
    # a cache-resident sensor layout (ch_locations_2d prefers it)
    np.save(os.path.join(cache_dir, "layout.npy"),
            synthetic_cap_locations(C).astype(np.float32))
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"num_channels": int(C)}, f)
    np.save(os.path.join(cache_dir, "x_dict.npy"), x_dict, allow_pickle=True)
    np.save(os.path.join(cache_dir, "y_dict.npy"), y_dict, allow_pickle=True)
    np.save(os.path.join(cache_dir, "meg_onsets.npy"), meg_onsets,
            allow_pickle=True)
    np.save(os.path.join(cache_dir, "speech_onsets.npy"), speech_onsets,
            allow_pickle=True)
    np.save(os.path.join(cache_dir, "sentence_idxs.npy"), sentence_idxs,
            allow_pickle=True)
    return Config({
        "dataset": "Gwilliams2022",
        "cache_dir": cache_dir,
        "split_ratio": 0.8,
        "split_mode": "sentence",
        "num_channels": C,
        "preprocs": {
            "brain_resample_rate": rate,
            "seq_len_sec": 3,
            "baseline_len_sec": 0.5,
            "shift_brain": True,
            "shift_len": 150,
            "clamp": True,
            "clamp_lim": 20,
            "last4layers": False,
        },
    })


def make_synthetic_god_dataset(root, num_channels=12, num_roi=8, fs=200.0,
                               n_train=20, n_test=10, feat_dim=16,
                               subjects=("sbj01",), seed=0,
                               meg_dtype=np.float64) -> Config:
    """Write synthetic GOD sessions in the Brainstorm-export .mat schema the
    real loaders read (MEG ``F`` + struct-array ``Events``, label .mats with
    ``vec_image``/``vec_index``, trigger .mats — reference
    load_meg.py:12-103), plus montage.csv and ch_region.json; returns a
    minimal config pointing at them.  A label-dependent channel pattern is
    planted so classification/retrieval is learnable.  ``meg_dtype`` is the
    type ``F`` is stored in (the loader reads it as float64 either way);
    the same seed writes the same values in either type."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)

    # region json: one region with num_roi channels (1-indexed)
    ch_region_path = os.path.join(root, "ch_region.json")
    with open(ch_region_path, "w") as f:
        json.dump({"occipital": {"left": list(range(1, num_roi // 2 + 1)),
                                 "right": list(range(num_roi // 2 + 1, num_roi + 1))}},
                  f)
    montage_path = os.path.join(root, "montage.csv")
    np.savetxt(montage_path, rng.rand(num_channels, 3), delimiter=",")

    subjects_cfg = {}
    for sub in subjects:
        for d in ["mat", "labels", "trigger"]:
            os.makedirs(os.path.join(root, sub, d), exist_ok=True)

        def write_session(split, n):
            T = int(fs * (n + 4))
            meg = rng.randn(num_channels, T) * 1e-12  # MEG-scale amplitudes
            triggers = (np.arange(n) + 1.0)  # seconds
            labels = rng.permutation(n) + 1  # 1-indexed image ids
            feats = rng.randn(n, feat_dim)
            # a decodable signal: the channel pattern depends on the label
            for t, lab in zip(triggers, labels):
                s = int(t * fs)
                meg[:, s:s + int(0.3 * fs)] += (
                    1e-12 * np.outer(np.sin(np.arange(num_channels) * lab),
                                     np.ones(int(0.3 * fs))))
            # Brainstorm-style Events: a MATLAB struct array (one record per
            # event type; the loaders index records by field position —
            # [0] = label, [3] = times); a non-visual first record exercises
            # the search loop
            ev_dt = np.dtype([("label", object), ("color", object),
                              ("epochs", object), ("times", object)])
            ev = np.zeros((1, 2), dtype=ev_dt)
            ev[0, 0] = (np.array(["motor"]), np.zeros((1, 1)),
                        np.zeros((1, 1)), np.array([[0.5]]))
            ev[0, 1] = (np.array(["visual"]), np.zeros((1, 1)),
                        np.zeros((1, 1)),
                        np.linspace(1.0, n, 60).reshape(1, -1))
            scipy.io.savemat(os.path.join(root, sub, "mat", f"{split}.mat"),
                             {"F": meg.astype(meg_dtype, copy=False), "Events": ev})
            scipy.io.savemat(os.path.join(root, sub, "labels", f"{split}.mat"),
                             {"vec_image": feats, "vec_index": labels.reshape(1, -1)})
            scipy.io.savemat(os.path.join(root, sub, "trigger", f"{split}.mat"),
                             {"trigger": triggers.reshape(1, -1)})

        write_session("train", n_train)
        write_session("val", n_test)
        subjects_cfg[sub] = {
            "fs": fs,
            "train": {"mat": ["train.mat"], "labels": ["train.mat"],
                      "trigger": ["train.mat"], "rest": ["train.mat"]},
            "val": {"mat": ["val.mat"], "labels": ["val.mat"],
                    "trigger": ["val.mat"], "rest": ["val.mat"]},
        }

    return Config({
        "dataset": "GOD",
        "data_root": root,
        "subjects": subjects_cfg,
        "region": ["occipital/left", "occipital/right"],
        "ch_region_path": ch_region_path,
        "montage_path": montage_path,
        "num_meg_channels": num_channels,
        "z_scoring": False,
        "rest_duration": 10,
        "normalize_meg": False,
        "normalize_image_features": False,
        "window": {"start": 0.0, "end": 0.2},
        "preprocs": {
            "brain_filter": [1.0, 40.0],
            "brain_resample_rate": 100,
            "baseline_len_sec": 0.05,
            "clamp": True,
            "clamp_lim": 20,
            "last4layers": False,
        },
    })


def make_synthetic_brennan_raw(root, n_subjects=4, C=8, fs=500.0,
                               rec_sec=60.0, F=16, seed=0) -> Config:
    """Write synthetic Brennan-format raw .mat EEG files (fieldtrip-style
    ``raw`` struct — reference brennan2018.py:248-258) under
    ``{root}/data/Brennan2018/raw`` and an embedding stream at the brain
    rate (120 Hz) as ``{root}/data/Brennan2018/Y_embeds/embd_wav2vec.npy``
    (what the trainer reads instead of embedding the audio); returns a
    minimal config pointing at them.  At most 6 subjects (S01, S03–S06,
    S08: none of them excluded)."""
    from scipy.signal import resample as sp_resample

    rng = np.random.RandomState(seed)
    raw_dir = os.path.join(root, "data", "Brennan2018", "raw")
    os.makedirs(raw_dir, exist_ok=True)
    T = int(fs * rec_sec)
    rate = 120.0
    Ty = int(rate * rec_sec)
    Y = rng.randn(F, Ty).astype(np.float32)
    # EEG = channel-mixed, upsampled Y + noise (decodable)
    Y_at_fs = sp_resample(Y, T, axis=-1)
    subj_ids = [1, 3, 4, 5, 6, 8][:n_subjects]  # avoid excluded S02/S07
    for i in subj_ids:
        mix = rng.randn(C, F) * 0.5
        eeg = mix @ Y_at_fs + 0.1 * rng.randn(C, T)
        entry = np.zeros((1,), dtype=[("trial", "O"), ("fsample", "O"),
                                      ("label", "O")])
        trial = np.zeros((1, 1), dtype=object)
        trial[0, 0] = eeg
        entry[0]["trial"] = trial
        entry[0]["fsample"] = np.array([[fs]])
        entry[0]["label"] = np.array([["ch"]])
        scipy.io.savemat(os.path.join(raw_dir, f"S{i:02d}.mat"),
                         {"raw": entry.reshape(1, 1)})
    y_dir = os.path.join(root, "data", "Brennan2018", "Y_embeds")
    os.makedirs(y_dir, exist_ok=True)
    np.save(os.path.join(y_dir, "embd_wav2vec.npy"), Y)
    return Config({
        "dataset": "Brennan2018",
        "root_dir": root,
        "split_ratio": 0.8,
        "num_channels": C,
        "preprocs": {
            "brain_resample_rate": rate,
            "brain_filter_low": 1.0,
            "brain_filter_high": 50.0,
            "seq_len_sec": 3,
            "baseline_len_sec": 0.5,
            "shift_brain": True,
            "shift_len": 150,
            "subject_wise": True,
            "clamp": True,
            "clamp_lim": 20,
            "last4layers": False,
        },
    })


def full_width_god(work: str, seed: int, overrides=(),
                   config_name: str = "config_GOD") -> Config:
    """The full-width GOD set-up of the on-card smoke run:
    ``configs/config_GOD.yaml`` (brain_encoder, D1 = 270, D2 = 320, F = 512,
    mean-pooled, B = 64, rest z-scoring, 2–5 Hz bandpass, 120 Hz, window
    0.2–0.4 s → T = 24, ``training_mode: cv``) with ``overrides``, over
    ``FULL_WIDTH_GOD`` sessions written once under ``{work}/god``: one
    subject, 203 channels at 1000 Hz, one train session of 600 trials and
    one val session of 50 (the real dataset has several sessions per
    subject: the one cut), CLIP features of width 512, and a 50 × 512
    ``image_features.npy`` zero-shot gallery.  The 22 ROI channels and their
    positions come from the packaged region table and montage."""
    root = os.path.join(work, "god")
    sessions = make_synthetic_god_dataset(root, seed=seed, **FULL_WIDTH_GOD)
    gallery = os.path.join(root, "image_features.npy")
    np.save(gallery, np.random.RandomState(seed + 1).randn(
        FULL_WIDTH_GOD["n_test"], FULL_WIDTH_GOD["feat_dim"]).astype(np.float32))
    cfg = compose(CONFIGS_DIR, config_name,
                  [f"data_root={root}", f"seed={seed}",
                   f"image_features_path={gallery}",
                   f"num_meg_channels={FULL_WIDTH_GOD['num_channels']}",
                   *overrides])
    # the synthetic sessions' manifest, and the packaged region table and
    # montage (config_GOD.yaml's paths point at the real dataset's files)
    cfg.subjects = sessions.subjects
    cfg.ch_region_path = cfg.montage_path = None
    return cfg


def full_width_speech(work: str, seed: int, overrides=(), device="cuda",
                      config_name: str = "config"
                      ) -> tuple[Config, GwilliamsPacked, np.ndarray]:
    """The full-width synthetic run set-up of the on-card smoke run and the
    step profiler: the ``FULL_WIDTH_CACHE`` cache under ``{work}/cache``
    (written once), ``configs/{config_name}.yaml`` (``config``, or a speed
    preset that composes it) over it with ``overrides``, the dataset packed
    on ``device``, and the shallow split's training segment ids.  Returns
    ``(cfg, ds, train_idx)``."""
    cache = os.path.join(work, "cache")
    if not os.path.exists(os.path.join(cache, "x_dict.npy")):
        make_synthetic_gwilliams_cache(cache, seed=seed, **FULL_WIDTH_CACHE)
    cfg = compose(CONFIGS_DIR, config_name,
                  [f"cache_dir={cache}", f"seed={seed}", *overrides])
    ds = build_gwilliams_dataset(cfg, *load_gwilliams_cache(cache),
                                 split_mode=cfg.split_mode, seed=seed,
                                 device=device)
    train_idx, _ = random_split(torch.Generator().manual_seed(seed), len(ds),
                                float(cfg.split_ratio))
    cfg.num_subjects = ds.num_subjects
    cfg.num_channels = int(ds.recordings.shape[2])
    return cfg, ds, train_idx
