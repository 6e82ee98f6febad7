"""Model factory: config → encoder module.  Port of the ``brain_encoder``
branch of ``meg_decoding_tpu/models/factory.py:get_model``; the other
model names come with their slices."""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

__all__ = ["get_model"]

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _resolve_F(cfg) -> int:
    # F becomes 1024 when the dataset uses wav2vec last-4-layer features
    # (reference models.py:348)
    if cfg.select("preprocs.last4layers", False):
        return 1024
    return int(cfg.get("F", 512))


def get_model(cfg, loc: np.ndarray, device: str | torch.device = "cuda",
              seed: int = 0) -> BrainEncoder:
    """Build the encoder named by ``cfg.model`` on ``device``, its initial
    weights drawn from a ``torch.Generator`` seeded with ``seed``."""
    name = cfg.model
    if name != "brain_encoder":
        raise NotImplementedError(
            f"model {name!r} is not ported yet (brain_encoder only)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return BrainEncoder(
        loc=loc,
        num_subjects=int(cfg.num_subjects),
        D1=int(cfg.get("D1", 270)),
        D2=int(cfg.get("D2", 320)),
        F=_resolve_F(cfg),
        K=int(cfg.get("K", 32)),
        d_drop=float(cfg.get("d_drop", 0.1)),
        seq2seq=bool(cfg.get("seq2seq", False)),
        dtype=_DTYPES[str(cfg.get("compute_dtype", "float32"))],
        gelu_approximate=bool(cfg.get("gelu_approximate", False)),
        gelu_impl=cfg.get("gelu_impl", None),
        emit_f32=not bool(cfg.get("emit_bf16_z", False)),
        device=dev,
        generator=gen,
    )
