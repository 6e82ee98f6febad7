"""Batch samplers driven by a ``torch.Generator``, and the GOD CV split.
Port of ``sample_with_replacement``, ``shuffle_batches``, ``god_cv_split``
and ``random_split`` from ``meg_decoding_tpu/data/sampling.py``.

Reference: ``meg_decoding/utils/get_dataloaders.py`` — ``RandomSampler(
replacement=True, num_samples=updates·batch_size)`` defines an epoch as a
fixed number of update steps (the Gwilliams/GOD mode); plain shuffle
batching otherwise.

The samplers are the JAX package's, but a ``torch.Generator`` does not
reproduce ``jax.random``: the same seed gives other indices.  Tests that
compare the two hand both sides the same indices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_with_replacement", "shuffle_batches", "god_cv_split",
           "random_split"]


def sample_with_replacement(generator: torch.Generator, n: int, updates: int,
                            batch_size: int) -> np.ndarray:
    """(updates, batch_size) indices drawn i.i.d. with replacement from [0, n)."""
    return torch.randint(0, n, (updates, batch_size),
                         generator=generator).numpy()


def shuffle_batches(generator: torch.Generator, n: int,
                    batch_size: int) -> np.ndarray:
    """Shuffled epoch split into full batches, (n // batch_size, batch_size);
    the remainder is dropped."""
    perm = torch.randperm(n, generator=generator).numpy()
    num_full = n // batch_size
    return perm[: num_full * batch_size].reshape(num_full, batch_size)


def god_cv_split(num_per_subject: int = 3600, num_subjects: int = 2,
                 test_fraction_start: int = 3000):
    """The reference's fixed-index GOD CV split (train_wowandb_cv.py:145-148):
    per subject-block of ``num_per_subject`` epochs, [0, start) train and
    [start, num_per_subject) test, over ``num_subjects`` consecutive
    blocks."""
    ind_tr, ind_te = [], []
    for s in range(num_subjects):
        base = s * num_per_subject
        ind_tr += list(range(base, base + test_fraction_start))
        ind_te += list(range(base + test_fraction_start, base + num_per_subject))
    return np.asarray(ind_tr), np.asarray(ind_te)


def random_split(generator: torch.Generator, n: int,
                 split_ratio: float) -> tuple[np.ndarray, np.ndarray]:
    """Shuffle-split indices (the reference's ``torch.random_split`` path,
    ``train.py:73-77``)."""
    perm = torch.randperm(n, generator=generator).numpy()
    n_train = int(round(n * split_ratio))
    return perm[:n_train], perm[n_train:]
