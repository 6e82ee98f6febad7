"""A closed training loop: one trainer enqueues step after step.

Set-up (``setup_s``, from the process's start): the program's kernels
found or built, the data and weights made on the card from the seed, the
train step built and captured, its first three steps (the comparison's:
192 or 768 distinct rows) and ``warmup_steps`` more.  The window starts
after a sync, replays steps until ``--seconds`` have passed on the host
clock, synchronises, and counts every step it ran over that whole time.
A traced run then traces ``trace_steps`` more.  The window's peak memory
is what the process holds on the card (``max_memory_reserved``), counted
from after the warm-up.  Once it is read and the program's state freed,
the reference runs the first three steps again from the same weights and
draws.

The rate is the record's ``rate`` (samples/s), which the cell reports
under its end-to-end metric of that unit.  The mix's keys:
``batch_size``, ``compute_dtype`` (float32 | bfloat16),
``gelu_impl`` (erf | tanh | erf_poly), ``collate`` (inline | cached),
``warmup_steps``, ``trace_steps``, ``control`` (the precision of the
comparison's control).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchcore import checks, counts
from benchcore.data import (
    SpeechData,
    make_data,
    make_weights,
    np_rng,
    sensor_locations,
)
from benchcore.trace import capture
from reference.model import fourier_basis, param_spec
from reference.train import gather_speech, precision, three_steps

FIRST_STEPS = 3


def weights_of(cfg: dict, seed: int, device) -> dict:
    m = cfg["model"]
    spec = param_spec(m["C"], cfg["data"]["subjects"], m["D1"], m["D2"],
                      m["F"], m["K"], m["num_blocks"])
    return make_weights(spec, m["init_temperature"], seed, device)


def window_draw(data, rng: np.random.Generator, B: int, C: int) -> dict:
    """One step's draws: uniform segments (or train rows), with
    replacement; for speech a session a segment; a dropout sensor."""
    if isinstance(data, SpeechData):
        return {"idx": rng.integers(0, data.segments, B),
                "sess": rng.integers(0, data.sessions, B),
                "centre": int(rng.integers(0, C))}
    return {"idx": rng.choice(data.train_rows, B), "centre": int(rng.integers(0, C))}


def first_draws(data, seed: int, B: int, C: int) -> list:
    """The comparison's three steps: rows that all differ."""
    rng = np_rng(seed, "first_steps")
    if isinstance(data, SpeechData):
        rows = rng.permutation(data.segments)[:FIRST_STEPS * B]
    else:
        rows = rng.permutation(data.train_rows)[:FIRST_STEPS * B]
    out = []
    for i in range(FIRST_STEPS):
        d = window_draw(data, rng, B, C)
        d["idx"] = rows[i * B:(i + 1) * B]
        out.append(d)
    return out


def reference_batch(data, draw: dict, device) -> dict:
    """The raw windows of a draw, cut by the reference's own indexing."""
    idx = torch.as_tensor(np.asarray(draw["idx"]), device=device)
    if isinstance(data, SpeechData):
        sess = torch.as_tensor(np.asarray(draw["sess"]), device=device)
        X, Y, subs = gather_speech(
            data.recordings, data.y_stream, data.meg_onsets,
            data.speech_onsets, data.session_subject, idx // data.words,
            idx % data.words, sess, data.seq_len)
    else:
        X, Y, subs = data.X[idx], data.Y[idx], data.subjects[idx]
    return {"X": X, "Y": Y, "subjects": subs, "centre": draw["centre"]}


def _norm(t) -> float:
    return float(t.detach().double().norm())


def program_first_steps(trainer, draws: list) -> dict:
    """The program's readings of the comparison's steps: each loss, each
    leaf's first gradient (from Adam's state after one step) and each
    leaf's change after the last."""
    start = {k: t.detach().clone() for k, t in trainer.leaves().items()}
    losses, grads = [], None
    for d in draws:
        m = trainer(d)
        if grads is None:
            grads = {k: _norm(g) for k, g in trainer.first_gradients().items()}
        losses.append(float(m["loss"]))
    end = trainer.leaves()
    return {"losses": losses, "grad_norms": grads,
            "change_norms": {k: _norm(end[k].float() - v.float())
                             for k, v in start.items()}}


def reference_first_steps(cfg: dict, data, draws: list, seed: int, device,
                          arithmetic: str = "float32") -> dict:
    m = cfg["model"]
    loc = torch.as_tensor(sensor_locations(cfg), device=device)
    cos, sin = fourier_basis(loc.cpu().numpy(), m["K"], device)
    weights = weights_of(cfg, seed, device)
    batches = [reference_batch(data, d, device) for d in draws]
    with precision(arithmetic, device) as q:
        return three_steps(weights, batches, m, loc, cos, sin, cfg["collate"],
                           cfg["optimizer"]["lr"], q)


def kernel_work(cfg: dict, mix: dict, data, draws: list) -> tuple:
    """``(least seconds, launches)`` by hand-written kernel over the steps
    of ``draws``, from their shapes and the bytes they need."""
    m, B = cfg["model"], mix["batch_size"]
    esize = 2 if mix["compute_dtype"] == "bfloat16" else 4
    bn_n = B * m["D2"]
    least, launches = {}, {}

    def add(kind, nbytes, n=1):
        least[kind] = least.get(kind, 0.0) + counts.least_seconds(nbytes) * n
        launches[kind] = launches.get(kind, 0) + n

    speech = isinstance(data, SpeechData)
    if speech:
        meg_on = data.meg_onsets.cpu().numpy()
        speech_on = data.speech_onsets.cpu().numpy()
    for d in draws:
        if speech:
            L, W = data.seq_len, data.words
            Tp = data.recordings.shape[-1]
            task, word = d["idx"] // W, d["idx"] % W
            rec = d["sess"] * data.recordings.shape[1] + task
            cov_x = counts.covered_samples(rec, meg_on[d["sess"], task, word],
                                           L, Tp)
            cov_y = counts.covered_samples(task, speech_on[task, word], L, Tp)
            add("window_gather",
                counts.window_gather_bytes(cov_x, m["C"], B, L, 4))
            add("window_gather",
                counts.window_gather_bytes(cov_y, m["F"], B, L, esize))
            T = L
        else:
            T = data.X.shape[-1]
        if mix["collate"] == "inline":
            add("robust_quantiles", counts.quantile_bytes(B * m["C"], T))
        n = 2 * m["num_blocks"]
        add("bn_stats", counts.bn_stats_bytes(bn_n * T, esize, m["D2"]), n)
        add("bn_bwd", counts.bn_bwd_bytes(bn_n * T, esize, m["D2"]), n)
    return least, launches


def run(ctx) -> dict:
    from benchcore import port

    ctx.mark("imports")
    cfg, mix = ctx.config, ctx.mix
    dev = port.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        ctx.mark("device")
        port.build_kernels()
        ctx.mark("kernels")
    B, C = mix["batch_size"], cfg["model"]["C"]
    data = make_data(cfg, ctx.seed, dev)
    weights = weights_of(cfg, ctx.seed, dev)
    ctx.sync()
    ctx.mark("data")
    trainer = port.Trainer(cfg, mix, data, weights, sensor_locations(cfg), dev)
    del weights
    ctx.sync()
    ctx.mark("program")
    draws = first_draws(data, ctx.seed, B, C)
    prog = program_first_steps(trainer, draws)
    ctx.mark("first_steps")
    rng = np_rng(ctx.seed, "window")
    if cuda:
        torch.cuda.empty_cache()
    for _ in range(mix["warmup_steps"]):
        trainer(window_draw(data, rng, B, C))
    ctx.sync()
    if cuda:
        # the peak is the window's: what the process holds on the card
        # (the data, the state, the graph's pool) from here on
        torch.cuda.reset_peak_memory_stats(dev)
    ctx.mark("warmup")
    before = port.counters()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    hist = []
    while True:
        hist.append(trainer(window_draw(data, rng, B, C)))
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t_start
    replays = port.counters()["replays.train"] - before["replays.train"]
    n = len(hist)
    record = {"e2e": {"setup_s": setup_s},
              "rate": {"value": n * B / window_s, "unit": "samples/s"},
              "attempted": n,
              "step_s": window_s / n,
              "step_flops": counts.step_flops(
                  B, C, data.seq_len if isinstance(data, SpeechData)
                  else data.X.shape[-1], cfg["model"]["D1"],
                  cfg["model"]["D2"], cfg["model"]["F"], cfg["model"]["K"],
                  cfg["model"]["seq2seq"], cfg["model"]["num_blocks"]),
              "peak_flops": counts.peak_flops(mix["compute_dtype"])}
    if ctx.trace:
        traced = [window_draw(data, rng, B, C)
                  for _ in range(mix["trace_steps"])]
        record["trace"] = capture(lambda: [trainer(d) for d in traced],
                                  len(traced), ctx.sync)
        record["kernel_least_s"], record["kernel_launches"] = kernel_work(
            cfg, mix, data, traced)
    record["failed"] = int(torch.stack([h["skipped"] for h in hist]).sum())
    record["memory_peak_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                   if cuda else 0)
    del trainer, hist
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_first_steps(cfg, data, draws, ctx.seed, dev)
    record["numbers"] = {**checks.train_numbers(prog, ref),
                         "eager_steps": float(n - replays if cuda else 0)}
    return record
