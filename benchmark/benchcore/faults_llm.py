"""Faults planted in the program's text embedding, for the benchmark's own
tests and ``benchmark/calibrate_text.py``: a run of the
``text_embed_closed_loop`` cells with one of them must come out not
``correct``.  Each is a context manager that patches the program while it
is active; build the model and capture its graphs inside it.

* ``shared_dropped``: the MoE layers leave out their shared experts;
* ``cache_not_carried``: each chunk attends to zeros where the earlier
  chunks' latents are (the cache is not carried from chunk to chunk);
* ``route_negated``: the first MoE layer routes on its negated logits;
* ``m2_dropped``: the attention's scale leaves out YaRN's m²;
* ``rope_interleaved``: the rope pairs are left interleaved (rotate_half
  pairs dim i with i + d/2 of the projection as it comes).
"""

from __future__ import annotations

import contextlib

from benchcore.faults import _patched

__all__ = ["FAULTS", "planted"]

FAULTS = ("shared_dropped", "cache_not_carried", "route_negated",
          "m2_dropped", "rope_interleaved")


@contextlib.contextmanager
def planted(fault: str):
    from meg_decoding_tpu_torch.features import deepseek_v2_model as dm

    if fault == "shared_dropped":
        with _patched(dm.DeepseekV2MoE, "_shared", lambda self, x: None):
            yield
    elif fault == "cache_not_carried":
        def prefix(self, cache, start, end):
            out = cache[:end].clone()
            out[:start] = 0
            return out

        with _patched(dm.MLA, "_prefix", prefix):
            yield
    elif fault == "route_negated":
        logits = dm.DeepseekV2MoE._logits

        def negated(self, x):
            out = logits(self, x)
            return -out if self.index == 0 else out

        with _patched(dm.DeepseekV2MoE, "_logits", negated):
            yield
    elif fault == "m2_dropped":
        with _patched(dm, "softmax_scale", lambda cfg: cfg.q_head_dim ** -0.5):
            yield
    elif fault == "rope_interleaved":
        with _patched(dm, "_deinterleave", lambda x: x):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r} ({FAULTS})")
