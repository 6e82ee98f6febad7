"""The program's Kimi-Linear text encoder as the Kimi cell drives it:
``meg_decoding_tpu_torch/features/text_llm.py:load_text_llm`` builds the
model ("moonshotai/Kimi-Linear-48B-A3B-Instruct", the random backend,
the configuration's keys laid over the published ones: the experts this
card holds), then ``embed_words_last4_avg`` runs one document a request,
every chunk a replay of the model's chunk graph (``chunk_forward``).
With ``benchcore/port.py`` (whose device, kernel build and counters it
shares) and ``port_llm.py``, the only modules of the benchmark that import
the program.

The weights come from the benchmark (``drivers/kimi_embed_closed_loop.py``),
one at a time, and are copied into the model in place before anything is
captured.
"""

from __future__ import annotations

import torch

from benchcore.port import build_kernels, counters, device
from meg_decoding_tpu_torch.features import text_llm
from meg_decoding_tpu_torch.features.kimi_linear_model import KimiLinearModel

__all__ = ["MODEL", "device", "build_kernels", "counters", "Embedder"]

MODEL = "moonshotai/Kimi-Linear-48B-A3B-Instruct"


class Embedder:
    """``embedder(ids, word_ends) → E``: the words' last-four means (H,
    n_words) on the card of one document (ids 1-D int64 in host memory;
    the program uploads them).  ``routes(n)``: the experts the last
    request routed its first n tokens to, (MoE layers, n, k) on the host;
    ``expert_counts()`` and ``held_pairs()``: the program's counters after
    the last request."""

    def __init__(self, cfg: dict, weights, dev, seed: int = 0):
        model = text_llm.load_text_llm(MODEL, backend="random", device=dev,
                                       seed=seed, config=cfg)
        if not isinstance(model, KimiLinearModel):
            raise TypeError(f"load_text_llm built {type(model).__name__}")
        params = dict(model.named_parameters())
        seen = set()
        with torch.no_grad():
            for name, t in weights:
                params[name].copy_(t)
                seen.add(name)
        if seen != set(params):
            raise KeyError("weights and model differ: "
                           f"{sorted(seen ^ set(params))[:5]}")
        self.model = model
        t = cfg["text"]
        self.chunking = {"chunk_tokens": t["chunk_tokens"],
                         "cache_positions": t["cache_positions"]}

    def __call__(self, ids, word_ends):
        return text_llm.embed_words_last4_avg(self.model, ids, word_ends,
                                              **self.chunking)

    def routes(self, n: int) -> torch.Tensor:
        return self.model.route_ids[:, :n].to("cpu", copy=True)

    def expert_counts(self):
        return self.model.expert_counts.to("cpu", copy=True).numpy()

    def held_pairs(self):
        return self.model.held_pairs().to("cpu", copy=True).numpy()
