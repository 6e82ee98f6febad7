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

from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.data.layout import synthetic_cap_locations

__all__ = ["make_synthetic_gwilliams_cache"]


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
