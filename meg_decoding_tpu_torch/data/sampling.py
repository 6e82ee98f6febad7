"""Batch samplers driven by a ``torch.Generator``.
Port of ``random_split`` from ``meg_decoding_tpu/data/sampling.py``.

The split is the same shuffle-split as the JAX package's, but a
``torch.Generator`` does not reproduce ``jax.random.permutation``: the same
seed gives another permutation.  Tests that compare the two hand both sides
the same indices.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["random_split"]


def random_split(generator: torch.Generator, n: int,
                 split_ratio: float) -> tuple[np.ndarray, np.ndarray]:
    """Shuffle-split indices (the reference's ``torch.random_split`` path,
    ``train.py:73-77``)."""
    perm = torch.randperm(n, generator=generator).numpy()
    n_train = int(round(n * split_ratio))
    return perm[:n_train], perm[n_train:]
