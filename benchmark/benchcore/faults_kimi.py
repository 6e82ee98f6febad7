"""Faults planted in the program's Kimi-Linear text embedding, for the
benchmark's own tests and ``benchmark/calibrate_kimi.py``: a run of the
``kimi_embed_closed_loop`` cell with one of them must come out not
``correct``.  Each is a context manager that patches the program while it
is active; build the model and capture its graphs inside it.

* ``route_negated``: the first MoE layer routes on its negated logits;
* ``kda_state_dropped``: every chunk's KDA layers start from a zero state
  (the state is not carried from chunk to chunk);
* ``conv_tail_dropped``: every chunk's short convolutions start from zero
  tails (the last three inputs of the chunk before are not carried);
* ``kda_decay_scalar``: each head's decay is the mean of its 128 channels'
  (a scalar-gated delta rule, as Gated DeltaNet's, in place of KDA's
  channel-wise one).
"""

from __future__ import annotations

import contextlib

from benchcore.faults import _patched

__all__ = ["FAULTS", "planted"]

FAULTS = ("route_negated", "kda_state_dropped", "conv_tail_dropped",
          "kda_decay_scalar")


@contextlib.contextmanager
def planted(fault: str):
    from meg_decoding_tpu_torch.features import kimi_linear_model as km

    kda = km.KimiDeltaAttention
    if fault == "route_negated":
        logits = km.KimiSparseMoeBlock._logits

        def negated(self, x):
            out = logits(self, x)
            return -out if self.index == 0 else out

        with _patched(km.KimiSparseMoeBlock, "_logits", negated):
            yield
    elif fault in ("kda_state_dropped", "conv_tail_dropped"):
        start = kda._start

        def dropped(self, ctx, state, tail):
            start(self, ctx, state, tail)
            (state if fault == "kda_state_dropped" else tail).zero_()

        with _patched(kda, "_start", dropped):
            yield
    elif fault == "kda_decay_scalar":
        gate = kda._gate

        def scalar(self, x):
            g = gate(self, x)
            return g.mean(-1, keepdim=True).expand_as(g).contiguous()

        with _patched(kda, "_gate", scalar):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r} ({FAULTS})")
