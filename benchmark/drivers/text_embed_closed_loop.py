"""A closed-loop client of the text-stimulus encoder: it sends one
document a request, its token ids and word ends in (pageable) host
memory, as a feature build holds a story's text, and waits for the
(H, n_words) features in host memory before it sends the next.  The
program uploads the ids, runs the document in fixed-size chunks (each a
replay of its chunk graph, through its latent cache) and the client
copies the result back.

Set-up (``setup_s``): the program's kernels found or built, the model's
weights made on the card from the seed, one at a time, and copied into
the program's model, the pool of documents made from the seed and copied
to host memory, then the warm-up: the pool's longest document (its chunks
capture every chunk position's graph, so nothing is captured in the
window; a program that replays no chunk graph there cannot run the cell,
and the run stops with an error) and ``warmup_requests`` requests.  The
window's peak memory is what the process holds on the card
(``max_memory_reserved``: the graphs' pool with it), counted from after
the warm-up.  The window sends the pool's documents in an order drawn
from the seed, pass after pass, and ends at the end of the first whole
pass after ``--seconds`` (``min_passes`` at least), so that every window
holds each document equally often; each request's latency is its
host-clock time from the send to the features in host memory.  The first
request of a document of each of ``kept_chunks`` chunk counts (drawn from
the seed among those) keeps its features and the experts the program
routed its tokens to.  A traced run then traces ``trace_requests`` more;
its unit is a chunk.  Once the peak memory is read and the program's
state freed, the reference (``reference/deepseek_v2.py``) embeds the kept
documents again, routed as the program routed them.

The pool: ``documents`` documents whose lengths are evenly spaced up to
``max_tokens``, the j-th (from 1) ``max_tokens``·j / ``documents``
tokens rounded (a fixed ladder, the same for every seed: at 24 up to
16,384 in 2,048-token chunks, three documents of each of 1 to 8 chunks);
ids drawn uniformly over the vocabulary from the seed, words of
``word_tokens`` [least, most] tokens each drawn from the seed (the last
word cut at the document's end).  The mix's keys: those, and
``warmup_requests``, ``min_passes``, ``kept_chunks``, ``trace_requests``,
``control`` (the precision of the comparison's control).

The compared numbers: ``output``, the worst kept document's max |E −
E_ref| over max |E_ref| (inf where the shapes differ); ``route_gap``, the
largest over the kept documents' MoE layers and tokens of the reference's
own k-th largest routing probability less its least among the program's
k choices (0 where they agree); ``words``, the largest |n_words −
n_words_ref|; ``eager_chunks``, the window's chunks that did not replay a
graph.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from benchcore import checks
from benchcore.counts import PEAKS
from benchcore.counts_llm import doc_flops
from benchcore.data import np_rng, torch_gen
from benchcore.trace import capture
from reference import deepseek_v2 as ref
from reference.train import precision


def draw(name: str, shape, init: str, cfg: dict, seed: int, device):
    """One weight, bf16 on ``device``, from its own stream of the seed."""
    if init == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    t = torch.empty(shape, dtype=torch.bfloat16, device=device)
    return t.normal_(0.0, cfg.get("initializer_range", 0.02),
                     generator=torch_gen(device, seed, "weights", name))


def weights(cfg: dict, seed: int, device):
    """Every weight of ``reference.deepseek_v2.param_spec``, one at a
    time: ``(name, tensor)``."""
    for name, shape, init in ref.param_spec(cfg):
        yield name, draw(name, shape, init, cfg, seed, device)


def weight_fn(cfg: dict, seed: int, device):
    """``weight(name)``: the same weights, drawn when asked for."""
    spec = {name: (shape, init) for name, shape, init in ref.param_spec(cfg)}

    def weight(name):
        shape, init = spec[name]
        return draw(name, shape, init, cfg, seed, device)

    return weight


def lengths(mix: dict) -> list:
    n = mix["documents"]
    return [int(round(mix["max_tokens"] * (j + 1) / n)) for j in range(n)]


def documents(cfg: dict, mix: dict, seed: int, device) -> list:
    """The pool: ``(ids, word_ends)`` a document, ids int64 in (pageable)
    host memory made on ``device``, word ends int64 (numpy)."""
    ns = lengths(mix)
    flat = torch.randint(0, cfg["vocab_size"], (sum(ns),), device=device,
                         generator=torch_gen(device, seed, "tokens"))
    ids = list(torch.split(flat.cpu(), ns))
    rng = np_rng(seed, "words")
    lo, hi = mix["word_tokens"]
    out = []
    for t, n in zip(ids, ns):
        ends = np.cumsum(rng.integers(lo, hi + 1, size=n))
        ends = ends[ends < n]
        out.append((t, np.append(ends, n).astype(np.int64)))
    return out


def chunks_of(cfg: dict, n_tokens: int) -> int:
    return -(-n_tokens // cfg["text"]["chunk_tokens"])


def kept_docs(cfg: dict, mix: dict, docs: list, seed: int) -> list:
    """One document of each of ``kept_chunks`` chunk counts, drawn from the
    seed."""
    rng = np_rng(seed, "kept")
    counts = [chunks_of(cfg, len(ids)) for ids, _ in docs]
    out = []
    for c in mix["kept_chunks"]:
        among = [j for j, n in enumerate(counts) if n == c]
        if not among:
            raise ValueError(f"no document of the pool has {c} chunks: "
                             f"{counts}")
        out.append(int(rng.choice(among)))
    return out


def reference_outputs(cfg: dict, docs: list, routes, seed: int, device,
                      arithmetic: str = "float32") -> list:
    """``(E_ref, info)`` of each of ``docs`` (``(ids, ends)``), routed as
    ``routes`` (one (layers, n, k) tensor a document, or None a document:
    the reference's own routing)."""
    weight = weight_fn(cfg, seed, device)
    out = []
    with precision(arithmetic, device) as q:
        for (ids, ends), r in zip(docs, routes):
            out.append(ref.embed_words(
                weight, cfg, ids.to(device), ends,
                None if r is None else list(r.to(device)), q))
    return out


def compare(outputs: list, refs: list) -> dict:
    """``output``, ``route_gap`` and ``words`` of the kept documents
    (``refs``: ``reference_outputs``'s)."""
    gaps, words = [], []
    for E, (R, _) in zip(outputs, refs):
        words.append(abs(E.shape[-1] - R.shape[-1]))
        gaps.append(checks.serve_gap(E, R) if E.shape == R.shape
                    else math.inf)
    return {"output": max(gaps) if gaps else math.inf,
            "route_gap": max((info["route_gap"] for _, info in refs),
                             default=math.inf),
            "words": float(max(words)) if words else math.inf}


def run(ctx) -> dict:
    from benchcore import port_llm as port

    ctx.mark("imports")
    cfg, mix = ctx.config, ctx.mix
    dev = port.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        ctx.mark("device")
        port.build_kernels()
        ctx.mark("kernels")
    embedder = port.Embedder(cfg, weights(cfg, ctx.seed, dev), dev)
    docs = documents(cfg, mix, ctx.seed, dev)
    chunks = [chunks_of(cfg, len(ids)) for ids, _ in docs]
    flops = [doc_flops(cfg, len(ids)) for ids, _ in docs]
    kept = kept_docs(cfg, mix, docs, ctx.seed)
    order = [int(j) for j in np_rng(ctx.seed, "order").permutation(len(docs))]
    ctx.mark("data")
    if cuda:
        torch.cuda.empty_cache()
    before = port.counters()["replays.forward"]
    longest = max(range(len(docs)), key=lambda j: chunks[j])
    for j in [longest] + [order[i % len(order)]
                          for i in range(mix["warmup_requests"])]:
        embedder(*docs[j]).cpu()
    replayed = port.counters()["replays.forward"] - before
    if cuda and replayed == 0:
        raise RuntimeError("the program replayed no chunk graph in the "
                           "warm-up: it cannot run this cell")
    if cuda:
        # the peak is the window's: what the process holds on the card
        # (the weights, the cache, the graphs' pool) from here on
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.mark("warmup")
    before = port.counters()["replays.forward"]
    lat, sent, outputs, routes, failed, passes = [], [], {}, {}, 0, 0
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    while True:
        for j in order:
            t = time.perf_counter()
            E = embedder(*docs[j]).cpu()
            lat.append(time.perf_counter() - t)
            sent.append(j)
            failed += not bool(torch.isfinite(E).all())
            if j in kept and j not in outputs:
                outputs[j] = E
                routes[j] = embedder.routes(len(docs[j][0]))
        passes += 1
        if (passes >= mix["min_passes"]
                and time.perf_counter() - t_start >= ctx.seconds):
            break
    replays = port.counters()["replays.forward"] - before
    ms = np.asarray(lat) * 1e3
    record = {"e2e": {"request_ms_p50": float(np.percentile(ms, 50)),
                      "request_ms_p95": float(np.percentile(ms, 95)),
                      "setup_s": setup_s},
              "attempted": len(lat), "failed": failed, "request_ms": ms,
              "passes": passes, "request_s": float(np.sum(lat)),
              "window_flops": float(sum(flops[j] for j in sent)),
              "peak_flops": PEAKS["bfloat16"],
              "expert_counts": embedder.expert_counts(),
              "llm": {"model": cfg,
                      "chunk_tokens": cfg["text"]["chunk_tokens"]}}
    if ctx.trace:
        traced = [order[k % len(order)] for k in range(mix["trace_requests"])]

        def run_traced():
            for j in traced:
                embedder(*docs[j]).cpu()

        record["trace"] = capture(run_traced,
                                  max(sum(chunks[j] for j in traced), 1),
                                  ctx.sync)
    record["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                   if cuda else 0)
    del embedder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    refs = reference_outputs(cfg, [docs[j] for j in kept], [routes[j]
                             for j in kept], ctx.seed, dev)
    window_chunks = sum(chunks[j] for j in sent)
    record["numbers"] = {**compare([outputs[j] for j in kept], refs),
                         "eager_chunks": float(window_chunks - replays
                                               if cuda else 0)}
    return record
