"""Profiler traces and step-phase timing.  Port of
``meg_decoding_tpu/utils/profiling.py``.

* ``profile_trace`` — a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a GPU is present) that writes a Chrome
  trace of its window into a directory: the trainers' ``profile_dir`` and
  ``profile_epoch`` keys (``train/loop.py:fit``).
* ``StepTimer`` accumulates host wall-clock time per named phase (the
  gather, the train step) and reports per-phase means in the epoch summary.
  Work on the card is asynchronous: a phase's time is the host's time to
  enqueue it, unless the phase ends in a synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch

__all__ = ["profile_trace", "StepTimer"]


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the window into ``log_dir/trace_<pid>_<n>.json`` (Chrome trace
    format, as ``torch.profiler`` exports it); does nothing when
    ``log_dir`` is None.  Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    def __init__(self):
        self._acc = defaultdict(float)
        self._n = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name] += time.perf_counter() - t0
            self._n[name] += 1

    def means_ms(self) -> dict:
        return {f"t_{k}_ms": 1e3 * self._acc[k] / max(self._n[k], 1)
                for k in self._acc}

    def reset(self) -> None:
        self._acc.clear()
        self._n.clear()
