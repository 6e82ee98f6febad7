"""Model factory: config → encoder module.  Port of
``meg_decoding_tpu/models/factory.py:get_model``.

Reference: ``meg_decoding/models.py:18-30``.  The same model names are
accepted, including the reference's ``brain_endcoder_seq2static`` typo and
``eegnet_sub`` mapping to plain EEGNet (``models.py:27-28``) unless
``eegnet_sub_fixed`` asks for the working per-subject variant.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.brain_encoder import (
    BrainEncoder,
    BrainEncoderSeq2Static,
)
from meg_decoding_tpu_torch.models.eegnet import EEGNet, EEGNetSub, LinearEncoder

__all__ = ["get_model", "MODEL_NAMES"]

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
MODEL_NAMES = ("brain_encoder", "brain_endcoder_seq2static", "eegnet",
               "eegnet_sub", "linear")
# levers only the brain_encoder family has (factory.py:46-55)
_BRAIN_ENCODER_LEVERS = ("gelu_approximate", "emit_bf16_z", "gelu_impl")


def _resolve_F(cfg) -> int:
    # F becomes 1024 when the dataset uses wav2vec last-4-layer features
    # (reference models.py:348)
    if cfg.select("preprocs.last4layers", False):
        return 1024
    return int(cfg.get("F", 512))


def _eegnet_T(cfg) -> int:
    """Samples in a window: (end − start) × the brain rate, rounded."""
    return int(round((cfg.window.end - cfg.window.start)
                     * cfg.preprocs.brain_resample_rate))


def get_model(cfg, loc: np.ndarray | None = None,
              device: str | torch.device = "cuda", seed: int = 0,
              num_channels: int | None = None) -> torch.nn.Module:
    """Build the encoder named by ``cfg.model`` on ``device``, its initial
    weights drawn from a ``torch.Generator`` seeded with ``seed``.  ``loc``
    (C, 2) sensor positions: the brain_encoder family; ``num_channels``:
    EEGNet and the linear encoder."""
    name = cfg.model
    if name not in MODEL_NAMES:
        raise ValueError(f"no model named {name!r} is prepared "
                         f"(known: {sorted(MODEL_NAMES)})")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if name not in ("brain_encoder", "brain_endcoder_seq2static"):
        for flag in _BRAIN_ENCODER_LEVERS:
            if cfg.get(flag, None):
                warnings.warn(f"config sets {flag} but model {name!r} has no "
                              "such lever — ignored", stacklevel=2)
        if num_channels is None:
            raise ValueError(f"model {name!r} needs num_channels")
    if name == "linear":
        return LinearEncoder(int(num_channels), out_dim=_resolve_F(cfg),
                             scp=bool(cfg.get("scp", True)),
                             T=_eegnet_T(cfg) if not cfg.get("scp", True) else None,
                             device=dev, generator=gen)
    if name in ("eegnet", "eegnet_sub"):
        kw = dict(num_channels=int(num_channels), T=_eegnet_T(cfg),
                  out_dim=_resolve_F(cfg), F1=int(cfg.get("F1", 16)),
                  D=int(cfg.get("D", 2)), F2=int(cfg.get("F2", 32)),
                  k1=int(cfg.get("k1", 30)), k2=int(cfg.get("k2", 4)),
                  p1=int(cfg.get("p1", 2)), p2=int(cfg.get("p2", 4)),
                  dr1=float(cfg.get("dr1", 0.5)), dr2=float(cfg.get("dr2", 0.5)),
                  device=dev, generator=gen)
        if name == "eegnet_sub" and cfg.get("eegnet_sub_fixed", False):
            return EEGNetSub(num_subjects=int(cfg.num_subjects), **kw)
        return EEGNet(**kw)
    if loc is None:
        raise ValueError(f"model {name!r} needs sensor locations")
    common = dict(
        loc=loc, num_subjects=int(cfg.num_subjects),
        D1=int(cfg.get("D1", 270)), D2=int(cfg.get("D2", 320)),
        F=_resolve_F(cfg), K=int(cfg.get("K", 32)),
        d_drop=float(cfg.get("d_drop", 0.1)),
        dtype=_DTYPES[str(cfg.get("compute_dtype", "float32"))],
        gelu_approximate=bool(cfg.get("gelu_approximate", False)),
        gelu_impl=cfg.get("gelu_impl", None),
        emit_f32=not bool(cfg.get("emit_bf16_z", False)),
        device=dev, generator=gen)
    if name == "brain_endcoder_seq2static":  # sic — the reference's spelling
        return BrainEncoderSeq2Static(
            ks_list=list(cfg.select("ConvBlocks.ks", [3, 3, 3, 3, 3])),
            **common)
    return BrainEncoder(seq2seq=bool(cfg.get("seq2seq", False)), **common)
