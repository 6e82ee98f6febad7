"""Device-resident packed dataset.  Port of ``PackedDataset`` from
``meg_decoding_tpu/data/packed.py`` (without ``to_host``: the host spill
path is not ported).

After preprocessing, a dataset is a few fixed-shape tensors on one device
(GOD: N × 22 channels × 24 samples).  A training "loader" is an index
array → one gather on the device; the reference's host DataLoader workers
(``configs/config.yaml:15``) have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["PackedDataset"]


@dataclasses.dataclass
class PackedDataset:
    """Epoched tensors on one device.

    X: (N, C, T) brain epochs; Y: (N, F) or (N, F, T') stimulus latents;
    subject_idxs: (N,) int64; labels: (N,) int64 or None (GOD image ids as
    the label files store them, 1-indexed).  The normalization statistics
    are numpy arrays kept for reuse on the val split (``god.py:44-65``)."""

    X: torch.Tensor
    Y: torch.Tensor
    subject_idxs: torch.Tensor
    labels: Optional[torch.Tensor] = None
    num_subjects: int = 1
    mean_X: Optional[np.ndarray] = None
    std_X: Optional[np.ndarray] = None
    mean_Y: Optional[np.ndarray] = None
    std_Y: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.X.shape[0])

    def gather(self, idx) -> tuple:
        """``(X, Y, subject_idxs[, labels])`` at ``idx`` (host or device
        ints), on the dataset's device."""
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.X.device)
        out = [self.X[idx], self.Y[idx], self.subject_idxs[idx]]
        if self.labels is not None:
            out.append(self.labels[idx])
        return tuple(out)

    def subset(self, idx) -> "PackedDataset":
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.X.device)
        return dataclasses.replace(
            self, X=self.X[idx], Y=self.Y[idx],
            subject_idxs=self.subject_idxs[idx],
            labels=None if self.labels is None else self.labels[idx])
