"""Checkpoints of the full train state over ``torch.save``.
Port of ``meg_decoding_tpu/train/checkpoint.py`` (orbax there).

Reference saves only ``state_dict`` → ``model_last.pt`` each epoch and
``model_best.pt`` on best test top-10 (``train.py:274``,
``train_wowandb_cv.py:349-357``).  Same last/best layout here, but the file
holds ``TrainState.state_dict()``: parameters, BN statistics, temperature,
Adam state, step and generator — everything an exact resume needs.

Every save is double-buffered: the new checkpoint is written beside the old
one (``<name>.new.pt``), then the generations rotate with atomic renames —
the previous complete checkpoint survives as ``<name>.old.pt`` until the
next save.  A crash at any point leaves at least one complete generation,
and ``restore`` tries ``.new → name → .old``: newest complete generation
first (a crash mid-rotation leaves ``.new`` as the freshest).
"""

from __future__ import annotations

import os
import pickle
import warnings

import torch

__all__ = ["CheckpointManager"]

# what torch.load raises on a truncated or corrupt file
_LOAD_ERRORS = (RuntimeError, EOFError, OSError, pickle.UnpicklingError)


class CheckpointManager:
    """``writer=False``: restores only, and ``save`` writes nothing — every
    data-parallel rank but 0 reads a resume and leaves the writing to
    rank 0."""

    def __init__(self, ckpt_dir: str, writer: bool = True):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        self.writer = writer
        if writer:
            os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.ckpt_dir, name + ".pt")

    def save(self, name: str, state) -> None:
        """Write ``<name>.new.pt`` fully, then rotate ``<name>.pt`` →
        ``<name>.old.pt`` and ``.new`` → ``<name>.pt``.  The previous
        complete checkpoint is never touched until the new one is on disk."""
        if not self.writer:
            return
        new, cur, old = (self._path(name + ".new"), self._path(name),
                         self._path(name + ".old"))
        with open(new, "wb") as f:
            torch.save(state.state_dict(), f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(cur):
            os.replace(cur, old)
        os.replace(new, cur)

    def restore(self, name: str, state):
        """Load the newest restorable generation of ``name`` into ``state``
        (a ``TrainState`` of the same model) and return it; a generation
        that fails to load is skipped for the next older one."""
        errors = []
        device = state.step.device
        for cand in (name + ".new", name, name + ".old"):
            path = self._path(cand)
            if not os.path.exists(path):
                continue
            try:
                sd = torch.load(path, map_location=device, weights_only=True)
            except _LOAD_ERRORS as e:
                errors.append(f"{cand}: {type(e).__name__}: {e}")
                continue
            state.load_state_dict(sd)
            if cand != name:
                warnings.warn(
                    f"restored generation '{cand}' of checkpoint '{name}'"
                    + (f" (errors: {'; '.join(errors)})" if errors else ""))
            return state
        raise FileNotFoundError(
            f"no restorable checkpoint '{name}' under {self.ckpt_dir}"
            + (f" (errors: {'; '.join(errors)})" if errors else ""))

    def exists(self, name: str) -> bool:
        """True when any generation of ``name`` is present."""
        return any(os.path.exists(self._path(n))
                   for n in (name, name + ".old", name + ".new"))
