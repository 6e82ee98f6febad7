"""A closed-loop client of the Kimi-Linear text-stimulus encoder, as
``text_embed_closed_loop.py`` is of DeepSeek-V2-Lite's (whose pool,
kept documents and comparison it shares): one document a request, its
token ids and word ends in (pageable) host memory; the program uploads
the ids, runs the document in fixed-size chunks (each a replay of its
chunk graph, through the MLA layers' latent cache and the KDA layers'
state and convolution tails) and the client copies the (H, n_words)
features back before it sends the next.

Set-up (``setup_s``): the program's kernels found or built, the model
built by the program's ``load_text_llm`` (its random backend, the
configuration's keys laid over the published ones) and the benchmark's
weights, made on the card from the seed one at a time, copied into it, the
pool made from the seed and copied to host memory, then the warm-up: the
pool's longest document (its chunks capture every chunk position's graph,
so nothing is captured in the window; a program that replays no chunk
graph there cannot run the cell, and the run stops with an error) and
``warmup_requests`` requests.  The window sends the pool's documents in
an order drawn from the seed, pass after pass, and ends at the end of the
first whole pass after ``--seconds`` (``min_passes`` at least); each
request's latency is its host-clock time from the send to the features in
host memory.  The first request of a document of each of ``kept_chunks``
chunk counts keeps its features and the experts the program routed its
tokens to.  A traced run then traces ``trace_requests`` more; its unit is
a chunk.  Once the peak memory is read and the program's state freed, the
reference (``reference/kimi_linear.py``: f32, KDA as the token
recurrence, the same held experts) embeds the kept documents again,
routed as the program routed them.

The pool, the mix's keys and the compared numbers (``output``,
``route_gap`` on the sigmoid choice scores s + bias, ``words``,
``eager_chunks``) are the text driver's.  The record adds, for the
readers, the held experts' pairs of the last request (``held_pairs``).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

import drivers.text_embed_closed_loop as tc
from benchcore.counts import PEAKS
from benchcore.counts_kimi import doc_flops
from benchcore.data import np_rng, torch_gen
from benchcore.trace import capture
from reference import kimi_linear as ref
from reference.train import precision


def draw(name: str, shape, init: str, cfg: dict, seed: int, device):
    """One weight on ``device`` from its own stream of the seed, by its
    ``init`` (``reference/kimi_linear.py:layer_spec``): bf16 but the f32
    selection bias, ``A_log`` and ``dt_bias``."""
    if init == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=device)
    gen = torch_gen(device, seed, "weights", name)
    std = cfg.get("initializer_range", 0.02)
    if init == "normal":
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        return t.normal_(0.0, std, generator=gen)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if init == "bias":
        return t.normal_(0.0, std, generator=gen)
    if init == "a_log":
        return t.uniform_(1.0, 16.0, generator=gen).log_()
    if init == "dt_bias":
        dt = t.uniform_(math.log(1e-3), math.log(0.1), generator=gen).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {init!r} of {name}")


def weights(cfg: dict, seed: int, device):
    """Every weight of ``reference.kimi_linear.param_spec``, one at a
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


def run(ctx) -> dict:
    from benchcore import port_kimi as port

    ctx.mark("imports")
    cfg, mix = ctx.config, ctx.mix
    dev = port.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        ctx.mark("device")
        port.build_kernels()
        ctx.mark("kernels")
    embedder = port.Embedder(cfg, weights(cfg, ctx.seed, dev), dev,
                             ctx.seed)
    docs = tc.documents(cfg, mix, ctx.seed, dev)
    chunks = [tc.chunks_of(cfg, len(ids)) for ids, _ in docs]
    flops = [doc_flops(cfg, len(ids)) for ids, _ in docs]
    kept = tc.kept_docs(cfg, mix, docs, ctx.seed)
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
        # (the weights, the caches and state, the graphs' pool) from here on
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
              "held_pairs": embedder.held_pairs(),
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
    record["numbers"] = {**tc.compare([outputs[j] for j in kept], refs),
                         "eager_chunks": float(window_chunks - replays
                                               if cuda else 0)}
    return record
