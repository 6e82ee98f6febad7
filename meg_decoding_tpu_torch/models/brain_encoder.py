"""Brain encoder.  Port of ``meg_decoding_tpu/models/brain_encoder.py``.

Reference: ``meg_decoding/models.py`` — ``SubjectBlock`` (244-273),
``BrainEncoder`` (341-383), ``BrainEncoderSeq2Static`` (465-512).  Called as ``model(X, subject_idxs)`` with
``X: (B, C, T)``; activations stay NCW throughout.  ``model.train()``
turns on spatial dropout (a training forward takes the dropout ``centre``
or a ``generator`` to draw it) and batch-statistics BatchNorm.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as Fnn

from meg_decoding_tpu_torch.models.layers import (
    Conv1x1,
    ConvBlock,
    SpatialAttention,
    SubjectLayers,
)
from meg_decoding_tpu_torch.ops.gelu import gelu, resolve_impl

__all__ = ["SubjectBlock", "BrainEncoder", "BrainEncoderSeq2Static"]


class SubjectBlock(nn.Module):
    """SpatialAttention → 1×1 conv (D1→D1, with bias) → per-subject 1×1 mix
    (no bias)."""

    def __init__(self, loc: np.ndarray, num_subjects: int, D1: int = 270,
                 K: int = 32, d_drop: float = 0.1,
                 dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spatial_attention = SpatialAttention(loc, D1=D1, K=K,
                                                  d_drop=d_drop,
                                                  device=device,
                                                  generator=generator)
        self.conv = Conv1x1(D1, D1, dtype=dtype, device=device,
                            generator=generator)
        self.subject_layer = SubjectLayers(num_subjects, D1, device=device,
                                           generator=generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor,
                centre: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        X = self.spatial_attention(X, centre=centre, generator=generator)
        X = self.conv(X)
        return self.subject_layer(X, subject_idxs)


class BrainEncoder(nn.Module):
    """SubjectBlock → ``num_blocks`` ConvBlocks → two 1×1 convs with GELU;
    seq2seq returns (B, F, T), else the time mean (B, F) — reduced in f32
    even when the compute dtype is bf16.

    ``dtype``: compute dtype of the convolutions (None = the input's, f32);
    parameters stay f32.  ``emit_f32`` casts the output to f32.
    ``generator`` draws the initial weights (torch's default ranges);
    ``d_drop`` is the spatial-dropout radius of training mode."""

    def __init__(self, loc: np.ndarray, num_subjects: int, D1: int = 270,
                 D2: int = 320, F: int = 512, K: int = 32, d_drop: float = 0.1,
                 seq2seq: bool = False, num_blocks: int = 5,
                 dtype: torch.dtype | None = None,
                 gelu_approximate: bool = False, gelu_impl: str | None = None,
                 emit_f32: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.seq2seq = seq2seq
        self.dtype = dtype
        self.emit_f32 = emit_f32
        self.gelu_impl = resolve_impl(gelu_impl, gelu_approximate)
        self.subject_block = SubjectBlock(loc, num_subjects, D1=D1, K=K,
                                          d_drop=d_drop, dtype=dtype,
                                          device=device, generator=generator)
        for k in range(num_blocks):
            self.add_module(f"conv{k}", ConvBlock(
                k, D1 if k == 0 else D2, D2, dtype=dtype,
                gelu_impl=self.gelu_impl, device=device, generator=generator))
        self.num_blocks = num_blocks
        self.conv_final1 = Conv1x1(D2, 2 * D2, dtype=dtype, device=device,
                                   generator=generator)
        self.conv_final2 = Conv1x1(2 * D2, F, dtype=dtype, device=device,
                                   generator=generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor,
                centre: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``centre``/``generator``: the spatial-dropout centre of a
        training forward, or the CPU generator to draw it (ignored in eval
        mode)."""
        X = self.subject_block(X, subject_idxs, centre=centre,
                               generator=generator)
        for k in range(self.num_blocks):
            X = getattr(self, f"conv{k}")(X)
        X = gelu(self.conv_final1(X), self.gelu_impl)
        X = gelu(self.conv_final2(X), self.gelu_impl)
        if self.emit_f32:
            X = X.to(torch.float32)
        if self.seq2seq:
            return X  # (B, F, T) like the reference
        if X.dtype == torch.bfloat16:
            return X.to(torch.float32).mean(dim=2).to(X.dtype)
        return X.mean(dim=2)  # (B, F)


class BrainEncoderSeq2Static(nn.Module):
    """BrainEncoder with per-block kernel sizes ``ks_list`` and an
    ``AvgPool1d(3, 2)`` (VALID) after blocks 0–3, then the time mean (in
    f32 for bf16) after block 4 and the two 1×1 convs with GELU → (B, F)
    (``brain_encoder.py:133-201``).  The pools need T ≥ 31."""

    def __init__(self, loc: np.ndarray, num_subjects: int,
                 ks_list: Sequence[int], D1: int = 270, D2: int = 320,
                 F: int = 512, K: int = 32, d_drop: float = 0.1,
                 dtype: torch.dtype | None = None,
                 gelu_approximate: bool = False, gelu_impl: str | None = None,
                 emit_f32: bool = True, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.emit_f32 = emit_f32
        self.gelu_impl = resolve_impl(gelu_impl, gelu_approximate)
        self.subject_block = SubjectBlock(loc, num_subjects, D1=D1, K=K,
                                          d_drop=d_drop, dtype=dtype,
                                          device=device, generator=generator)
        for k in range(5):
            self.add_module(f"conv{k}", ConvBlock(
                k, D1 if k == 0 else D2, D2, ks=int(ks_list[k]), dtype=dtype,
                gelu_impl=self.gelu_impl, device=device, generator=generator))
        self.conv_final1 = Conv1x1(D2, 2 * D2, dtype=dtype, device=device,
                                   generator=generator)
        self.conv_final2 = Conv1x1(2 * D2, F, dtype=dtype, device=device,
                                   generator=generator)

    def forward(self, X: torch.Tensor, subject_idxs: torch.Tensor,
                centre: int | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        X = self.subject_block(X, subject_idxs, centre=centre,
                               generator=generator)
        for k in range(5):
            X = getattr(self, f"conv{k}")(X)
            if k < 4:
                X = Fnn.avg_pool1d(X, 3, 2)
            elif X.dtype == torch.bfloat16:
                X = X.to(torch.float32).mean(dim=2, keepdim=True).to(X.dtype)
            else:
                X = X.mean(dim=2, keepdim=True)
        X = gelu(self.conv_final1(X), self.gelu_impl)
        X = gelu(self.conv_final2(X), self.gelu_impl)
        if self.emit_f32:
            X = X.to(torch.float32)
        return X[:, :, 0]  # (B, F)
