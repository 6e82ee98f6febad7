"""Step-phase timing.  Port of ``StepTimer`` from
``meg_decoding_tpu/utils/profiling.py``.

``StepTimer`` accumulates host wall-clock time per named phase (the
train step) and reports per-phase means in the epoch summary.  Work on the
card is asynchronous: a phase's time is the host's time to enqueue it,
unless the phase ends in a synchronize.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

__all__ = ["StepTimer"]


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
