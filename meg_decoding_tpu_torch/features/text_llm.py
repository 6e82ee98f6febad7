"""Text-stimulus features: a language model's per-word hidden states.

Aligning MEG with a language model's activations over the words of the
stories heard or read is a standard target (Caucheteux & King, Commun.
Biol. 2022, with GPT-2).  The port has two models:

* DeepSeek-V2-Lite (``features/deepseek_v2_model.py``), whole on one card
  in bf16 (15.5 B parameters without the LM head, 31.0 GB): MLA over a
  latent cache, 64 softmax-routed experts;
* Kimi-Linear-48B-A3B (``features/kimi_linear_model.py``): 20 layers of
  Kimi Delta Attention (a gated delta rule, whose state per document is a
  fixed (heads, 128, 128) matrix a layer) beside 7 MLA layers without
  rope, 256 sigmoid-routed experts of which a card holds its share
  (``experts_first``, ``experts_held``).  Its per-token cost does not grow
  with the story, which suits whole audiobook stories.

``embed_words_last4_avg`` gives each word the mean over its tokens of the
mean of the last four hidden states (transformers'
``output_hidden_states[-4:]``, the last of which has the final norm
applied), as ``features/wav2vec.py:embed_last4_avg`` takes the speech
features: (H, n_words).

A document runs in fixed chunks of ``chunk_tokens`` tokens (the last one
zero-padded; causality keeps the padding out of every real position).
Chunk k sees every earlier position of its document through the model's
per-document state, which the chunk writes in place and the next one
reads: MLA's latent rows (512-d latent and 64-d rope key a token an MLA
layer, 1,152 bytes; the prefix's keys and values are expanded from it
every chunk), and, for Kimi-Linear, the KDA layers' f32 state and their
convolutions' last three inputs, carried from chunk to chunk (the chunk
at position 0 starts them from zero).  Every chunk replays a CUDA graph
of the model's chunk forward (``chunk_forward``:
``train/graph.py:GraphedStep``, kind ``forward``): one graph a chunk
position (its input ``positions`` has the chunk's end as its length, so
each position is a signature of its own, captured at its first chunk),
each with static shapes; on the CPU the same route runs eagerly.  Nothing
of an earlier document is read: chunk k reads only what its own
document's chunks 0..k wrote.  The cache holds ``cache_positions`` tokens
(16,384 by default; a longer document raises).

The model's ``expert_counts`` holds, after a call, the tokens each routed
expert received in each MoE layer over the request (padding left out),
and ``route_ids`` the experts each token was routed to.

Spans (``utils/profiling.py``): ``llm.embed`` (``request=``) around each
call, ``llm.chunk`` (``chunk=``) around each chunk's host work: its
buffer, the graph's call, the slice it keeps.

Backends of ``load_text_llm``: ``random`` (the architecture with weights
drawn on the device from a seeded ``torch.Generator``), ``hf`` (a local
checkpoint, ``features/hf_checkpoint.py``), ``auto`` (``hf``, else
``random`` with a loud message).  The model is chosen by the checkpoint's
``model_type`` (``deepseek_v2``, ``kimi_linear``), else by its name.  No
tokenizer is in the repository: the entry point takes token ids and word
ends.
"""

from __future__ import annotations

import itertools
import weakref

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features import hf_checkpoint
from meg_decoding_tpu_torch.features.deepseek_v2_model import (
    DeepseekV2Config,
    DeepseekV2Model,
)
from meg_decoding_tpu_torch.features.kimi_linear_model import (
    KimiLinearConfig,
    KimiLinearModel,
)
from meg_decoding_tpu_torch.train.graph import GraphedStep
from meg_decoding_tpu_torch.utils.profiling import scope, span

__all__ = ["load_text_llm", "embed_words_last4_avg", "chunk_forward",
           "word_mean", "CHUNK_TOKENS", "CACHE_POSITIONS"]

CHUNK_TOKENS = 2048
CACHE_POSITIONS = 16384

_graphs = weakref.WeakKeyDictionary()  # model → its chunk forward
_requests = itertools.count()          # ids of the llm.embed spans
_chunks = itertools.count()            # ids of the llm.chunk spans


# model_type → (its config class, its model class)
MODELS = {"deepseek_v2": (DeepseekV2Config, DeepseekV2Model),
          "kimi_linear": (KimiLinearConfig, KimiLinearModel)}


def _model_type(model_name: str, d: dict | None) -> str:
    """``model_type`` of a config.json, else the model's by its name."""
    if d and d.get("model_type") in MODELS:
        return d["model_type"]
    return "kimi_linear" if "kimi-linear" in model_name.lower() \
        else "deepseek_v2"


def load_text_llm(model_name: str = "deepseek-ai/DeepSeek-V2-Lite",
                  backend: str = "random",
                  device: str | torch.device = "cuda",
                  seed: int = 0, config: dict | None = None):
    """The model in bf16 on ``device``, in eval mode, without gradients.
    backend: 'hf' | 'random' | 'auto' (``hf_checkpoint.load_encoder``);
    the random backend builds the named model's published architecture
    (DeepSeek-V2-Lite, or Kimi-Linear-48B-A3B for a name holding
    "Kimi-Linear") drawn from ``seed``.  ``config``: config.json keys laid
    over the architecture's (both backends), such as the routed experts a
    card holds (``experts_first``, ``experts_held``)."""
    dev = resolve_device(device)
    extra = dict(config or {})

    def from_dict(d: dict):
        d = {**d, **extra}
        return MODELS[_model_type(model_name, d)][0].from_dict(d)

    def build(cfg=None):
        cfg = from_dict({}) if cfg is None else cfg
        model_cls = next(m for c, m in MODELS.values() if isinstance(cfg, c))
        with dev:
            return model_cls(cfg, torch.bfloat16)

    return hf_checkpoint.load_encoder(
        model_name, backend, build, from_dict,
        lambda m: m.init_random(torch.Generator(device=dev).manual_seed(
            int(seed))),
        "text_llm", from_hf=hf_checkpoint.deepseek_v2_params_from_hf)


def chunk_forward(model) -> GraphedStep:
    """The model's chunk forward, ``graphed({"ids": (C,) int64,
    "positions": (L,) int64, "n_valid": (1,) int32}) → (C, H) f32``: the
    mean of the last four hidden states of C tokens at positions
    L − C .. L, written into and read from the model's per-document
    state; one graph a chunk end L, captured at its first chunk.  The
    graph reads the model's weights where they are and its ``reads`` are
    every weight but the routed experts' (14.4 of DeepSeek-V2-Lite's 15.5
    B, 23.6 of the 25.2 B Kimi-Linear holds with half its experts, whose
    copy would double the card's use during a capture's check); its
    ``writes`` are what a chunk updates in place for the next
    (``model.carried()``: the expert counter, Kimi-Linear's KDA state and
    convolution tails), put back after a capture's warm-up so that the
    chunk runs once on what the chunk before left.  ``.body(**inputs)``
    is the same forward run eagerly."""
    graphed = _graphs.get(model)
    if graphed is None:
        ref = weakref.ref(model)

        @torch.no_grad()
        def body(ids, positions, n_valid):
            hs = ref()(ids, positions, n_valid, keep=4)
            with scope("last4"):
                return torch.stack([h.float() for h in hs]).mean(dim=0)

        routed = {id(p) for p in model.routed_parameters()}
        graphed = _graphs[model] = GraphedStep(
            body, device=model.norm.weight.device,
            reads=[p for p in model.parameters() if id(p) not in routed]
            + list(model.buffers()), writes=model.carried())
    return graphed


def _word_plan(word_ends, n_tokens: int) -> tuple:
    """(starts, lengths) of the words (host int64), checked: ends strictly
    increasing, the last at most ``n_tokens``."""
    ends = np.asarray(word_ends, dtype=np.int64).reshape(-1)
    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    lengths = ends - starts
    if ends.size == 0 or lengths.min() < 1 or ends[-1] > n_tokens:
        raise ValueError("word_ends must rise strictly from 1 to at most the "
                         f"document's {n_tokens} tokens")
    return starts, lengths


def word_mean(tokens: torch.Tensor, word_ends) -> torch.Tensor:
    """(n_words, H): each word's mean over its tokens of ``tokens`` (n, H),
    the tokens added in order."""
    starts, lengths = _word_plan(word_ends, tokens.shape[0])
    dev = tokens.device
    s = torch.from_numpy(starts).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    acc = tokens.index_select(0, s)
    for j in range(1, int(lengths.max())):
        take = (ln > j)[:, None]
        row = tokens.index_select(0, torch.where(ln > j, s + j, s))
        acc = acc + torch.where(take, row, torch.zeros_like(row))
    return acc / ln[:, None].to(acc.dtype)


@torch.no_grad()
def embed_words_last4_avg(model, token_ids, word_ends,
                          chunk_tokens: int = CHUNK_TOKENS,
                          cache_positions: int = CACHE_POSITIONS
                          ) -> torch.Tensor:
    """(H, n_words) f32 on the model's device: each word's mean over its
    tokens of the mean of the last four hidden states (module docstring).
    ``token_ids``: the document's ids (1-D, host or device);
    ``word_ends``: each word's exclusive end among them."""
    with span("llm.embed", "request", next(_requests)):
        dev = model.norm.weight.device
        if not torch.is_tensor(token_ids):
            token_ids = torch.from_numpy(np.asarray(token_ids, np.int64))
        ids = token_ids.to(device=dev, dtype=torch.int64).reshape(-1)
        n, C = ids.shape[0], chunk_tokens
        if n > cache_positions or cache_positions % C:
            raise ValueError(f"{n} tokens in chunks of {C}: the cache holds "
                             f"{cache_positions} positions, a multiple of "
                             "the chunk")
        model.allocate(cache_positions)
        model.expert_counts.zero_()
        graphed = chunk_forward(model)
        pieces = []
        for start in range(0, n, C):
            with span("llm.chunk", "chunk", next(_chunks)):
                end = min(start + C, n)
                buf = torch.zeros(C, dtype=torch.int64, device=dev)
                buf[: end - start] = ids[start:end]
                valid = torch.full((1,), end - start, dtype=torch.int32,
                                   device=dev)
                out = graphed({"ids": buf,
                               "positions": model.positions[: start + C],
                               "n_valid": valid})
                pieces.append(out[: end - start])
        return word_mean(torch.cat(pieces), word_ends).T
