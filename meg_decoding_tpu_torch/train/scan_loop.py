"""The fused Gwilliams train step: session draw → window gather → train
step.  Port of the single-device branch of ``make_fused_speech_step`` in
``meg_decoding_tpu/train/scan_loop.py`` (``:259-288``).

In JAX the gather and the step compile into one program to save a
dispatch; PyTorch runs eagerly, so here the step is the gather
(``gather_speech_batch``: two launches of the ``window_gather`` kernel)
followed by ``make_train_step``'s step.  The whole-epoch scan, the mesh
and the cached collate statistics are not ported.
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    gather_speech_batch,
)
from meg_decoding_tpu_torch.train.optim import Adam
from meg_decoding_tpu_torch.train.steps import (
    CollateConfig,
    LossConfig,
    make_train_step,
)

__all__ = ["make_fused_speech_step"]


def _loss_y_dtype(model, loss_cfg: LossConfig):
    """Gather-time dtype of the Y windows: bf16 when the encoder computes
    in bf16 under the CLIP loss (the JAX package's PARITY deviation 15,
    symmetric with a bf16 Z), else None (Y's own f32)."""
    if loss_cfg.kind == "clip" and getattr(model, "dtype", None) == torch.bfloat16:
        return torch.bfloat16
    return None


def make_fused_speech_step(model, optimizer: Adam, loss_cfg: LossConfig,
                           collate_cfg: CollateConfig, ds: GwilliamsPacked):
    """Returns ``fused(state, idx, generator=None, sess_ids=None,
    centre=None) → (state, metrics)``: ``idx`` (B,) global segment ids of
    ``ds``; one session per segment from ``sess_ids`` when given, else drawn
    with ``generator``; ``centre`` is the spatial-dropout centre, drawn from
    ``state.generator`` when None."""
    step = make_train_step(model, optimizer, loss_cfg, collate_cfg)
    y_dtype = _loss_y_dtype(model, loss_cfg)

    def fused(state, idx, generator: torch.Generator | None = None,
              sess_ids=None, centre: int | None = None):
        X, Y, subs, _ = gather_speech_batch(ds, idx, sess_ids=sess_ids,
                                            generator=generator,
                                            y_dtype=y_dtype)
        return step(state, X, Y, subs, centre=centre)

    return fused
