"""Faults planted in the program's speech embedding, for the benchmark's
own tests and ``benchmark/calibrate_embed.py``: a run of the
``embed_closed_loop`` cells with one of them must come out not
``correct``.  Each is a context manager that patches the program while it
is active; a chunk graph captured inside it records the fault.

* ``mask_dropped``: the encoder ignores the sample mask, so the last,
  zero-padded chunk attends to its padding (a full chunk's mask holds
  every sample and changes nothing);
* ``stitch_shifted``: every chunk after the first keeps its frames one
  frame early, so each stitched piece is shifted by one frame (the
  embedding keeps its length).
"""

from __future__ import annotations

import contextlib

from benchcore.faults import _patched

__all__ = ["FAULTS", "planted"]

FAULTS = ("mask_dropped", "stitch_shifted")


@contextlib.contextmanager
def planted(fault: str):
    from meg_decoding_tpu_torch.features import wav2vec, wav2vec2_model

    if fault == "mask_dropped":
        forward = wav2vec2_model.Wav2Vec2Model.forward

        def unmasked(self, input_values, attention_mask=None, keep=None):
            return forward(self, input_values, None, keep)

        with _patched(wav2vec2_model.Wav2Vec2Model, "forward", unmasked):
            yield
    elif fault == "stitch_shifted":
        plan = wav2vec._chunk_plan

        def shifted(*a, **kw):
            out = plan(*a, **kw)
            return out[:1] + [(s, e, lo - 1, hi - 1) for s, e, lo, hi in out[1:]]

        with _patched(wav2vec, "_chunk_plan", shifted):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r} ({FAULTS})")
