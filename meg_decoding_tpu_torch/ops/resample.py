"""FFT-domain resampling (MNE ``mne.filter.resample`` equivalent).
Port of ``meg_decoding_tpu/ops/resample.py``.

Reference call site: ``mne.filter.resample(ROI_MEG_Data, down=fs/120)``
(``god.py:134``).  ``scipy.signal.resample`` semantics: transform, truncate
or zero-pad the one-sided spectrum (with the unpaired-Nyquist
compensation), inverse transform, rescale.  The JAX package chunks rows
through Bluestein FFTs for the TPU; here every row goes through one
``torch.fft`` call at the native length (``ops/fft.py``).
"""

from __future__ import annotations

import torch

from meg_decoding_tpu_torch.ops.fft import irfft_any, rfft_any

__all__ = ["resample_fft", "resample_len"]


def resample_len(n: int, up: float = 1.0, down: float = 1.0) -> int:
    """Output length for resampling ``n`` samples by ``up/down``: ``round``
    (MNE's semantics), not ``ceil``, so a ratio built as ``target/n`` with
    a 1-ulp error upward still lands on ``target``."""
    return int(round(n * up / down))


def resample_fft(x: torch.Tensor, up: float = 1.0,
                 down: float = 1.0) -> torch.Tensor:
    """Resample along the last axis by the rational/real factor up/down."""
    T = x.shape[-1]
    new_len = resample_len(T, up, down)
    X = rfft_any(x, T)
    m = min(new_len, T)
    Xr = X[..., :m // 2 + 1]
    if m % 2 == 0 and new_len != T:
        # the unpaired Nyquist bin (scipy.signal.resample)
        Xr = Xr.clone()
        Xr[..., m // 2] *= 2.0 if new_len < T else 0.5
    y = irfft_any(Xr, new_len)
    return (y * (new_len / T)).to(x.dtype)
