"""Faults planted under the timed path, for the benchmark's own tests and
for reading each fault's numbers on the card (``benchmark/calibrate.py``):
a run with one of them must come out not ``correct``.  Each is a context
manager that patches the program while it is active; a graph captured
inside it records the fault.

* ``state_unchanged``: the step leaves its state as it found it (no Adam
  update, no BN running statistics written);
* ``half_batch``: the CLIP loss over the first half of the batch, its
  mean taken over that half;
* ``answer_altered``: the encoder's output for the batch's first sample
  negated where it is produced.
"""

from __future__ import annotations

import contextlib

__all__ = ["FAULTS", "planted"]

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault: str):
    import torch

    from meg_decoding_tpu_torch.models import brain_encoder
    from meg_decoding_tpu_torch.train import optim, steps

    with contextlib.ExitStack() as stack:
        if fault == "state_unchanged":
            stack.enter_context(_patched(optim.Adam, "update",
                                         lambda self, *a, **k: None))
            stack.enter_context(_patched(steps, "commit_running_stats",
                                         lambda model, ok: None))
        elif fault == "half_batch":
            clip = steps.clip_loss

            def half(x, y, temp, **kw):
                h = x.shape[0] // 2
                return clip(x[:h], y[:h], temp, **kw)

            stack.enter_context(_patched(steps, "clip_loss", half))
        elif fault == "answer_altered":
            forward = brain_encoder.BrainEncoder.forward

            def altered(self, *a, **kw):
                Z = forward(self, *a, **kw)
                sign = Z.new_ones(Z.shape[0]).index_fill(
                    0, torch.zeros(1, dtype=torch.long, device=Z.device), -1.0)
                return Z * sign.view(-1, *([1] * (Z.dim() - 1)))

            stack.enter_context(_patched(brain_encoder.BrainEncoder,
                                         "forward", altered))
        else:
            raise ValueError(f"unknown fault {fault!r} ({FAULTS})")
        yield
