"""Arbitrary-length FFTs.  Port of ``meg_decoding_tpu/ops/fft.py``: the same
names and signatures, each one ``torch.fft`` call.

The JAX package computes non-power-of-two lengths with Bluestein's chirp-z
algorithm (three power-of-two FFTs) only because XLA's TPU FFT lowers other
lengths to a dense DFT matmul.  cuFFT and PyTorch's CPU FFT take any length
directly, so the port needs no Bluestein.  Semantics kept: the input is
truncated or zero-padded to ``n`` along the last axis; ``irfft_any`` reads
the first ``n // 2 + 1`` bins, zero-padding a shorter half-spectrum
(upsampling).
"""

from __future__ import annotations

import torch

__all__ = ["rfft_any", "irfft_any", "fft_any", "ifft_any"]


def fft_any(x: torch.Tensor, n: int) -> torch.Tensor:
    """Complex FFT of length ``n`` along the last axis."""
    return torch.fft.fft(x, n=n)


def ifft_any(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse complex FFT of length ``n`` along the last axis."""
    return torch.fft.ifft(X, n=n)


def rfft_any(x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Real FFT along the last axis, (…, n // 2 + 1) bins."""
    return torch.fft.rfft(x, n=n)


def irfft_any(X: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT to length ``n``."""
    return torch.fft.irfft(X, n=n)
