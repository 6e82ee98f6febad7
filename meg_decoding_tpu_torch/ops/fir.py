"""FIR bandpass filtering: MNE-equivalent design, zero-phase application.
Port of ``meg_decoding_tpu/ops/fir.py``.

Reference call sites: ``mne.filter.filter_data(ROI_MEG_Data, sfreq=fs,
l_freq, h_freq)`` (``meg_decoding/dataclass/god.py:131``).  MNE's defaults:
one-pass, zero-phase, non-causal FIR, hamming window (firwin design);
transition bandwidths ``l_trans = min(max(0.25·l_freq, 2 Hz), l_freq)``,
``h_trans = min(max(0.25·h_freq, 2 Hz), nyq − h_freq)``; filter length
``3.3 / min(l_trans, h_trans) · sfreq``, rounded up to odd; edges padded
by reflection about the edge value ("reflect_limited") over half the
filter length.

The design is the JAX package's numpy/scipy code (on the host).  The JAX
package applies the filter by overlap-save with power-of-two blocks, since
the TPU's FFT is slow at other lengths; here it is one FFT convolution of
a length ≥ T + L − 1 whose only prime factors are 2, 3 and 5 (fast radices
of cuFFT and of PyTorch's CPU FFT), so the two agree to rounding.
"""

from __future__ import annotations

import numpy as np
import scipy.fft
import torch
import torch.nn.functional as Fnn
from scipy.signal import firwin

__all__ = ["design_bandpass_fir", "apply_fir", "bandpass_filter"]

_HAMMING_LENGTH_FACTOR = 3.3  # MNE _length_factors['hamming']


def _edge_lowpass(cutoff_hz: float, trans_hz: float, sfreq: float,
                  total_len: int) -> np.ndarray:
    """One edge's lowpass prototype, centered in a ``total_len`` buffer.
    Its length — and so this edge's transition width — comes from this
    edge's own transition bandwidth (``round(3.3·sfreq/trans)``, odd,
    capped at the total length), as MNE's ``_firwin_design`` composes
    multi-edge filters from per-edge prototypes."""
    nyq = sfreq / 2.0
    n = int(round(_HAMMING_LENGTH_FACTOR * sfreq / trans_hz))
    n += 1 - (n % 2)  # odd → symmetric, integer group delay
    n = min(n, total_len if total_len % 2 else total_len - 1)
    lp = firwin(n, np.clip(cutoff_hz, 1e-6, nyq - 1e-6), window="hamming",
                pass_zero=True, fs=sfreq)
    out = np.zeros(total_len)
    off = (total_len - n) // 2
    out[off:off + n] = lp
    return out


def design_bandpass_fir(sfreq: float, l_freq: float | None,
                        h_freq: float | None,
                        filter_length: int | None = None) -> np.ndarray:
    """Design an MNE-style hamming-window FIR band/low/high-pass filter:
    per-edge transition bandwidths, total length from the narrowest one,
    band-pass = LP(high edge) − LP(low edge), high-pass = δ − LP(edge).
    Returns float64 taps."""
    nyq = sfreq / 2.0
    trans = []
    if l_freq is not None and l_freq > 0:
        l_trans = min(max(0.25 * l_freq, 2.0), l_freq)
        trans.append(l_trans)
    else:
        l_freq = None
    if h_freq is not None and h_freq < nyq:
        h_trans = min(max(0.25 * h_freq, 2.0), nyq - h_freq)
        trans.append(h_trans)
    else:
        h_freq = None
    if not trans:
        return np.array([1.0])
    if filter_length is None:
        filter_length = int(np.ceil(_HAMMING_LENGTH_FACTOR / min(trans) * sfreq))
    if filter_length % 2 == 0:
        filter_length += 1

    if l_freq is not None and h_freq is not None:
        h = (_edge_lowpass(h_freq + h_trans / 2.0, h_trans, sfreq, filter_length)
             - _edge_lowpass(l_freq - l_trans / 2.0, l_trans, sfreq,
                             filter_length))
    elif l_freq is not None:  # high-pass: spectral inversion of the edge LP
        h = -_edge_lowpass(l_freq - l_trans / 2.0, l_trans, sfreq,
                           filter_length)
        h[filter_length // 2] += 1.0
    else:  # low-pass
        h = _edge_lowpass(h_freq + h_trans / 2.0, h_trans, sfreq,
                          filter_length)
    return h.astype(np.float64)


def _reflect_limited_pad(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """MNE 'reflect_limited': reflect about the edge value (2·edge − x)."""
    left = 2 * x[..., :1] - x[..., 1:n_pad + 1].flip(-1)
    right = 2 * x[..., -1:] - x[..., x.shape[-1] - n_pad - 1:-1].flip(-1)
    return torch.cat([left, x, right], dim=-1)


def apply_fir(x: torch.Tensor, h: torch.Tensor,
              pad: str = "reflect_limited") -> torch.Tensor:
    """Zero-phase application of an odd-length symmetric FIR along the last
    axis.  x: (…, T); h: (L,) taps, L odd, in x's dtype and device."""
    L = h.shape[0]
    n_edge = (L - 1) // 2
    T = x.shape[-1]
    if pad == "reflect_limited":
        n_pad = min(n_edge, T - 1)
        xp = _reflect_limited_pad(x, n_pad)
    elif pad == "zero":
        n_pad = n_edge
        xp = Fnn.pad(x, (n_edge, n_edge))
    else:
        raise ValueError(pad)
    # the linear convolution of xp with h, then the zero-phase slice
    n_fft = scipy.fft.next_fast_len(xp.shape[-1] + L - 1, real=True)
    y = torch.fft.irfft(torch.fft.rfft(xp, n=n_fft) * torch.fft.rfft(h, n=n_fft),
                        n=n_fft)
    start = n_pad + n_edge
    return y[..., start:start + T].to(x.dtype)


def bandpass_filter(x: torch.Tensor, sfreq: float, l_freq: float | None,
                    h_freq: float | None) -> torch.Tensor:
    """``filter_data`` equivalent: design on the host, apply on x's device.
    x: (…, T)."""
    h = design_bandpass_fir(sfreq, l_freq, h_freq)
    return apply_fir(x, torch.as_tensor(h, dtype=x.dtype, device=x.device))
