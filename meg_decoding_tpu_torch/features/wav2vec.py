"""wav2vec2 speech embeddings.  Port of ``meg_decoding_tpu/features/wav2vec.py``.

Reference: ``meg_decoding/utils/wav2vec_util.py`` — loads HF
``facebook/wav2vec2-large-xlsr-53`` and averages the last four hidden layers
(``getW2VLastFourLayersAvg``, :14-32) → (1024, T'); the alternative
``feature_extractor`` path yields 512-d conv features
(``brennan2018.py:187-189``).

The network is the port's own module (``features/wav2vec2_model.py``);
the JAX package runs transformers' Flax model.  As there, a long waveform
is embedded in overlapping chunks of one fixed size (the last one
zero-padded, with a sample mask), and only each chunk's interior is kept,
so chunk boundaries leave no imprint; the chunk embeddings stay on the
device until they are concatenated.

Backends of ``load_wav2vec``: ``random`` (the xlsr-53 architecture with
weights drawn on the device from a seeded ``torch.Generator``), ``hf`` (a
local Hugging Face checkpoint: ``features/hf_checkpoint.py``), ``auto``
(``hf``, else ``random`` with a loud message).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features import hf_checkpoint
from meg_decoding_tpu_torch.features.wav2vec2_model import (
    XLSR53,
    Wav2Vec2Config,
    Wav2Vec2Model,
)

__all__ = ["load_wav2vec", "embed_last4_avg", "embed_features",
           "w2v_output_rate", "read_wav"]

_W2V_FRAME_RATE = 16000 / 320  # conv stack stride 320 → 49.99 Hz


def w2v_output_rate() -> float:
    return _W2V_FRAME_RATE


def load_wav2vec(model_name: str = "facebook/wav2vec2-large-xlsr-53",
                 backend: str = "auto", num_hidden_layers: int = 24,
                 device: str | torch.device = "cuda",
                 seed: int = 0) -> Wav2Vec2Model:
    """The encoder on ``device``, in eval mode, without gradients.
    backend: 'hf' | 'random' | 'auto' (``hf_checkpoint.load_encoder``).

    ``num_hidden_layers`` and ``seed`` only affect the random backend
    (tests use a shallow model; frame rate and last-4 semantics are
    depth-independent)."""
    dev = resolve_device(device)

    def build(cfg=dataclasses.replace(XLSR53, num_hidden_layers=num_hidden_layers)):
        with dev:
            return Wav2Vec2Model(cfg)

    return hf_checkpoint.load_encoder(
        model_name, backend, build, Wav2Vec2Config.from_dict,
        lambda m: m.init_random(torch.Generator(device=dev).manual_seed(int(seed))),
        "wav2vec")


def read_wav(path: str) -> tuple[int, np.ndarray]:
    """(sample rate, 1-D f32 waveform) of a ``.wav`` file; integer samples
    are scaled by their dtype's maximum, as the JAX package reads them."""
    from scipy.io import wavfile

    sr, w = wavfile.read(path)
    if w.dtype.kind == "i":
        w = w / np.iinfo(w.dtype).max
    return int(sr), np.asarray(w, dtype=np.float32).reshape(-1)


def _num_frames(config: Wav2Vec2Config, n_samples: int) -> int:
    """Conv-stack output length for ``n_samples`` input samples."""
    return config.num_frames(n_samples)


def _waveform(model: Wav2Vec2Model, waveform) -> torch.Tensor:
    """A 1-D f32 waveform on the model's device."""
    if not torch.is_tensor(waveform):
        waveform = torch.from_numpy(np.asarray(waveform, dtype=np.float32))
    dev = next(model.parameters()).device
    return waveform.to(device=dev, dtype=torch.float32).reshape(-1)


def _last4(model: Wav2Vec2Model, wav: torch.Tensor,
           mask: torch.Tensor | None = None) -> torch.Tensor:
    """The mean of the last four hidden states of one (T,) chunk → (T', H)."""
    hs = model(wav[None], None if mask is None else mask[None], keep=4)
    return torch.stack(hs).mean(dim=0)[0]


@torch.no_grad()
def embed_last4_avg(model: Wav2Vec2Model, waveform,
                    chunk_sec: float = 20.0, overlap_sec: float = 1.0,
                    sample_rate: int = 16000) -> torch.Tensor:
    """Average of the last four hidden layers over the full waveform →
    (H, T') on the model's device.

    Overlap-chunked to bound memory; interiors are stitched so chunk
    boundaries don't imprint (unlike reference ``wav2vec_util.py:22-24``).
    Every chunk has one fixed size: the final short chunk is zero-padded
    and masked, with only its valid conv frames emitted."""
    wav = _waveform(model, waveform)
    cfg = model.config
    stride = cfg.stride  # 320 for wav2vec2
    chunk = (int(chunk_sec * sample_rate) // stride) * stride
    T = wav.shape[0]
    if T <= chunk:
        return _last4(model, wav).T

    # Chunk starts are stride-aligned so frame i of a chunk at sample s is
    # global frame s//stride + i; interiors are stitched seamlessly.
    ov_frames = max(int(round(overlap_sec * sample_rate / stride)), 1)
    n_chunk_frames = _num_frames(cfg, chunk)
    if n_chunk_frames <= 2 * ov_frames:
        raise ValueError(
            f"chunk_sec={chunk_sec} yields {n_chunk_frames} frames but "
            f"overlap_sec={overlap_sec} consumes 2×{ov_frames}; the chunk "
            "window would walk backwards and never finish — increase "
            "chunk_sec or decrease overlap_sec")
    frame_pos = torch.arange(chunk, device=wav.device)
    pieces = []
    pos = 0  # next global frame index to emit
    start = 0
    while True:
        end = min(start + chunk, T)
        buf = torch.zeros(chunk, dtype=torch.float32, device=wav.device)
        buf[: end - start] = wav[start:end]
        emb = _last4(model, buf, frame_pos < (end - start))  # (n_chunk, H)
        n_valid = (n_chunk_frames if end - start == chunk
                   else _num_frames(cfg, end - start))
        g0 = start // stride
        lo = pos - g0
        hi = n_valid if end == T else n_valid - ov_frames
        pieces.append(emb[lo:hi])
        pos = g0 + hi
        if end == T:
            break
        start += (n_valid - 2 * ov_frames) * stride
    return torch.cat(pieces, dim=0).T  # (H, T')


@torch.no_grad()
def embed_features(model: Wav2Vec2Model, waveform) -> torch.Tensor:
    """Conv feature-extractor path → (512, T') (brennan2018.py:187-189)."""
    return model.feature_extractor(_waveform(model, waveform)[None])[0].T
