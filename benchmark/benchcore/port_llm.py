"""The program's text-stimulus encoder as the text cells drive it:
``meg_decoding_tpu_torch/features/text_llm.py:embed_words_last4_avg`` over
one document a request, every chunk a replay of the model's chunk graph
(``chunk_forward``: ``train/graph.py:GraphedStep``, kind ``forward``).
With ``benchcore/port.py`` (whose device, kernel build and counters it
shares), the only modules of the benchmark that import the program.

The model is the program's ``DeepseekV2Model`` built from the
configuration's keys (transformers' names), in bf16; the weights come from
the benchmark (``drivers/text_embed_closed_loop.py``), one at a time, and
are copied into it in place before anything is captured.
"""

from __future__ import annotations

import torch

from benchcore.port import build_kernels, counters, device
from meg_decoding_tpu_torch.features import text_llm
from meg_decoding_tpu_torch.features.deepseek_v2_model import (
    DeepseekV2Config,
    DeepseekV2Model,
)

__all__ = ["device", "build_kernels", "counters", "Embedder"]


class Embedder:
    """``embedder(ids, word_ends) → E``: the words' last-four means (H,
    n_words) on the card of one document (ids 1-D int64 in host memory;
    the program uploads them).  ``routes(n)``: the experts the last
    request routed its first n tokens to, (MoE layers, n, k) on the host;
    ``expert_counts()``: the program's counter after the last request."""

    def __init__(self, cfg: dict, weights, dev):
        with torch.device(dev):
            model = DeepseekV2Model(DeepseekV2Config.from_dict(cfg),
                                    torch.bfloat16)
        model.eval().requires_grad_(False)
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
