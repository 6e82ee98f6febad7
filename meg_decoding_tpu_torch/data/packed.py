"""Device-resident packed dataset.  Port of ``PackedDataset`` from
``meg_decoding_tpu/data/packed.py``.

After preprocessing, a dataset is a few fixed-shape tensors on one device
(GOD: N × 22 channels × 24 samples).  A training "loader" is an index
array → one gather on the device; the reference's host DataLoader workers
(``configs/config.yaml:15``) have no counterpart.

``to_host`` spills a dataset that would not fit on the card to host
memory: CPU tensors, in pinned memory when the source is on CUDA, so that
a batch's copy to the card can run on a side stream
(``data/prefetch.py``).  A gather on a host-resident set slices on the
host into a pinned batch (``host_index``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["PackedDataset", "host_copy", "host_index"]


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host memory: a pinned CPU copy of a CUDA tensor, a CPU
    tensor as it is."""
    if t.device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def host_index(src: torch.Tensor, idx) -> torch.Tensor:
    """``src[idx]`` along dim 0 of a host tensor, into pinned memory when
    ``src`` is pinned (so the batch can be copied to the card
    asynchronously)."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64)
    out = torch.empty((len(idx), *src.shape[1:]), dtype=src.dtype,
                      pin_memory=src.is_pinned())
    return torch.index_select(src, 0, idx, out=out)


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
    host_resident: bool = False

    def __len__(self) -> int:
        return int(self.X.shape[0])

    def _take(self, idx) -> list:
        if self.host_resident:
            take = lambda t: host_index(t, idx)  # noqa: E731
        else:
            idx = torch.as_tensor(idx, dtype=torch.int64, device=self.X.device)
            take = lambda t: t[idx]  # noqa: E731
        out = [take(self.X), take(self.Y), take(self.subject_idxs)]
        return out + [None if self.labels is None else take(self.labels)]

    def gather(self, idx) -> tuple:
        """``(X, Y, subject_idxs[, labels])`` at ``idx`` (host or device
        ints), on the dataset's device; on a host-resident set, host
        slices (moved to the card by the prefetch, ``data/prefetch.py``)."""
        out = self._take(idx)
        return tuple(out if self.labels is not None else out[:3])

    def subset(self, idx) -> "PackedDataset":
        X, Y, subs, labels = self._take(idx)
        return dataclasses.replace(self, X=X, Y=Y, subject_idxs=subs,
                                   labels=labels)

    def to_host(self) -> "PackedDataset":
        """The same dataset in host memory (``host_copy``), for a set that
        exceeds the card's memory; train it with ``prefetch: N`` so that
        each batch's copy to the card runs under the previous step."""
        return dataclasses.replace(
            self, X=host_copy(self.X), Y=host_copy(self.Y),
            subject_idxs=host_copy(self.subject_idxs),
            labels=None if self.labels is None else host_copy(self.labels),
            host_resident=True)
