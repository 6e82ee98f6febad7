"""The serving forward: collate chain + eval-mode encoder.
Port of ``make_serving_forward`` from ``meg_decoding_tpu/serving/export.py``.

Clients send raw MEG windows as the sensors record them; the forward
applies the training-time collate (baseline correction → RobustScaler →
clamp) on the device and runs the encoder in eval mode.  No export
artifact yet: the model object itself is what serves.
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.ops.scaling import collate_preprocess

__all__ = ["make_serving_forward"]


def make_serving_forward(collate_cfg=None):
    """Returns ``forward(model, X, subject_idxs) -> Z`` (the JAX forward's
    ``variables`` argument is the module here).  X: (B, C, T) raw windows on
    the model's device."""
    enabled = bool(collate_cfg is not None
                   and getattr(collate_cfg, "enabled", True))

    @torch.no_grad()
    def forward(model, X, subject_idxs):
        model.eval()
        if enabled:
            X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                   collate_cfg.clamp_lim, collate_cfg.clamp)
        return model(X, subject_idxs)

    return forward
