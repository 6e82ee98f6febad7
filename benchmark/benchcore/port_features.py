"""The program's speech-stimulus encoder as the feature cells drive it:
``meg_decoding_tpu_torch/features/wav2vec.py:embed_last4_avg`` over one
stimulus file a request, every chunk a replay of the model's chunk graph
(``chunk_forward``: ``train/graph.py:GraphedStep``, kind ``forward``).
With ``benchcore/port.py`` (whose device, kernel build and counters it
shares), the only modules of the benchmark that import the program.

The model is the program's ``Wav2Vec2Model`` built from the
configuration's ``model`` section (transformers' key names); the weights
come from the benchmark (``drivers/embed_closed_loop.py``) and are copied
into it in place before anything is captured.
"""

from __future__ import annotations

import torch

from benchcore.port import build_kernels, counters, device
from meg_decoding_tpu_torch.features import wav2vec
from meg_decoding_tpu_torch.features.wav2vec2_model import (
    Wav2Vec2Config,
    Wav2Vec2Model,
)

__all__ = ["device", "build_kernels", "counters", "Embedder"]


class Embedder:
    """``embedder(waveform) → E``: the last-four mean (H, T′) on the card
    of one waveform (1-D f32, in host memory; the program uploads it)."""

    def __init__(self, cfg: dict, weights: dict, dev):
        with torch.device(dev):
            model = Wav2Vec2Model(Wav2Vec2Config.from_dict(cfg["model"]))
        model.eval().requires_grad_(False)
        params = dict(model.named_parameters())
        if set(params) != set(weights):
            raise KeyError("weights and model differ: "
                           f"{sorted(set(params) ^ set(weights))}")
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        self.model = model
        a = cfg["audio"]
        self.chunking = {"chunk_sec": a["chunk_sec"],
                         "overlap_sec": a["overlap_sec"],
                         "sample_rate": a["sample_rate"]}

    def __call__(self, waveform):
        return wav2vec.embed_last4_avg(self.model, waveform, **self.chunking)
