"""Synthetic Gwilliams2022 cache in the exact on-disk format the real
builder writes (``x_dict.npy``/``y_dict.npy``/onset tables — reference
``gwilliams2022.py:64-109``), so every downstream code path is the real one.

Port of ``make_synthetic_gwilliams_cache`` from
``meg_decoding_tpu/data/synthetic.py`` (numpy only; the same seed writes the
same files).  The MEG channels are a random linear mix of the task's
embedding stream plus noise, so contrastive retrieval is learnable.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.core.config import Config, compose
from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    build_gwilliams_dataset,
    load_gwilliams_cache,
)
from meg_decoding_tpu_torch.data.layout import synthetic_cap_locations
from meg_decoding_tpu_torch.data.sampling import random_split

__all__ = ["make_synthetic_gwilliams_cache", "full_width_speech",
           "CONFIGS_DIR", "FULL_WIDTH_CACHE"]

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "configs")
# 27 subjects at the widths of configs/config.yaml's speech model: C = 208
# sensors, F = 1024 embedding features, 120 Hz; 20 s per recording
FULL_WIDTH_CACHE = dict(n_subjects=27, n_sessions_per=1, C=208, rate=120,
                        rec_sec=20.0, words_per_task=96, F=1024)


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


def full_width_speech(work: str, seed: int, overrides=(), device="cuda"
                      ) -> tuple[Config, GwilliamsPacked, np.ndarray]:
    """The full-width synthetic run set-up of the on-card smoke run and the
    step profiler: the ``FULL_WIDTH_CACHE`` cache under ``{work}/cache``
    (written once), ``configs/config.yaml`` over it with ``overrides``, the
    dataset packed on ``device``, and the shallow split's training segment
    ids.  Returns ``(cfg, ds, train_idx)``."""
    cache = os.path.join(work, "cache")
    if not os.path.exists(os.path.join(cache, "x_dict.npy")):
        make_synthetic_gwilliams_cache(cache, seed=seed, **FULL_WIDTH_CACHE)
    cfg = compose(CONFIGS_DIR, "config",
                  [f"cache_dir={cache}", f"seed={seed}", *overrides])
    ds = build_gwilliams_dataset(cfg, *load_gwilliams_cache(cache),
                                 split_mode=cfg.split_mode, seed=seed,
                                 device=device)
    train_idx, _ = random_split(torch.Generator().manual_seed(seed), len(ds),
                                float(cfg.split_ratio))
    cfg.num_subjects = ds.num_subjects
    cfg.num_channels = int(ds.recordings.shape[2])
    return cfg, ds, train_idx
