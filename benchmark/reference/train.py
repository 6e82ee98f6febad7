"""The reference's training step and served forward, in plain PyTorch.

One step: the batch's windows cut by plain indexing → collate (baseline
correction over the first ``baseline`` samples, then each (sample,
channel) row scaled by its median and interquartile range, numpy's
linear percentiles, an IQR under 10·eps taken as 1, then a clamp) →
encoder in training mode → CLIP loss (rows Y, columns Z; both
L2-normalised over all but the batch axis; logits × exp(temp);
symmetric cross-entropy) → gradients of every weight and the
temperature → Adam (optax's ``scale_by_adam`` order: b1 0.9, b2 0.999,
eps 1e-8, constant learning rate) → BatchNorm running statistics.

``precision`` is the arithmetic of the convolutions and matrix
products: ``float32`` (TF32 off), ``tf32`` (TF32 on: on the card only)
or ``fp8`` (operands rounded to float8 e4m3 with one scale a tensor,
products summed in f32).
"""

from __future__ import annotations

import contextlib
import math

import torch

from reference.model import buffer_spec, forward

__all__ = ["PRECISIONS", "precision", "gather_speech", "collate",
           "clip_loss", "three_steps", "serve"]

PRECISIONS = ("float32", "tf32", "fp8")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _fp8(x):
    amax = x.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    r = (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (r - x).detach()


@contextlib.contextmanager
def precision(name: str, device):
    """Yields ``q``, the rounding of the operands, with the TF32 flags set
    for ``name`` and put back afterwards."""
    if name not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r} ({PRECISIONS})")
    if name == "tf32" and torch.device(device).type != "cuda":
        raise RuntimeError("TF32 exists on the card only")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield _fp8 if name == "fp8" else (lambda t: t)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def gather_speech(recordings, y_stream, meg_onsets, speech_onsets,
                  session_subject, task, word, sess, L: int):
    """(X, Y, subjects) of a batch: session ``sess`` task ``task``'s
    recording from its word's onset, and the task's stream from the
    word's onset, ``L`` samples each."""
    t = torch.arange(L, device=recordings.device)
    x_on = meg_onsets[sess, task, word].long()
    y_on = speech_onsets[task, word].long()
    C, Fy = recordings.shape[2], y_stream.shape[1]
    c = torch.arange(C, device=recordings.device)
    f = torch.arange(Fy, device=recordings.device)
    X = recordings[sess[:, None, None], task[:, None, None], c[None, :, None],
                   (x_on[:, None] + t)[:, None, :]]
    Y = y_stream[task[:, None, None], f[None, :, None],
                 (y_on[:, None] + t)[:, None, :]]
    return X, Y, session_subject[sess]


def _percentile(xs, p: float):
    """Linear percentile along the last axis of sorted rows."""
    n = xs.shape[-1]
    pos = p / 100.0 * (n - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    frac = pos - lo
    return xs[..., lo] * (1.0 - frac) + xs[..., hi] * frac


def collate(X, baseline: int, clamp_lim: float):
    if baseline > 0:
        X = X - X[..., :baseline].mean(dim=-1, keepdim=True)
    xs = torch.sort(X, dim=-1).values
    q25, med, q75 = (_percentile(xs, p) for p in (25.0, 50.0, 75.0))
    iqr = q75 - q25
    iqr = torch.where(iqr < 10 * _F32_EPS, torch.ones_like(iqr), iqr)
    return ((X - med[..., None]) / iqr[..., None]).clamp(-clamp_lim, clamp_lim)


def clip_loss(Y, Z, temp, q=lambda t: t):
    def unit(v):
        v = v.reshape(v.shape[0], -1)
        return v / torch.sqrt((v * v).sum(dim=1, keepdim=True).clamp(min=1e-24))

    logits = (q(unit(Y)) @ q(unit(Z)).T) * torch.exp(temp)
    target = torch.arange(logits.shape[0], device=logits.device)
    return (torch.nn.functional.cross_entropy(logits, target)
            + torch.nn.functional.cross_entropy(logits.T, target)) / 2


def _norm(t) -> float:
    return float(t.detach().double().norm())


def three_steps(weights: dict, batches: list, model: dict, loc, cos, sin,
                collate_cfg: dict, lr: float, q) -> dict:
    """Runs the steps of ``batches`` (each ``{"X", "Y", "subjects",
    "centre"}``: raw windows as gathered) from ``weights`` (the trained
    tensors by name, ``loss.temp`` among them; copied, not written) and
    fresh running statistics.  Returns each step's loss, every leaf's
    gradient norm at the first step, and the norm of every leaf's change
    (weights and running statistics) after the last."""
    w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    D2 = model["D2"]
    running = {}
    for name, shape in buffer_spec(D2, model["num_blocks"]):
        fill = 0.0 if name.endswith(".mean") else 1.0
        running[name] = torch.full(shape, fill, device=loc.device)
    start = {**{k: v.detach().clone() for k, v in w.items()},
             **{k: v.clone() for k, v in running.items()}}
    mu = {k: torch.zeros_like(v) for k, v in w.items()}
    nu = {k: torch.zeros_like(v) for k, v in w.items()}
    losses, first_grads = [], None
    for i, b in enumerate(batches, start=1):
        X = collate(b["X"], collate_cfg["baseline_len_samp"],
                    collate_cfg["clamp_lim"])
        Z, running = forward(w, running, X, b["subjects"], loc, cos, sin,
                             num_blocks=model["num_blocks"],
                             seq2seq=model["seq2seq"], train=True,
                             centre=b["centre"], d_drop=model["d_drop"], q=q)
        loss = clip_loss(b["Y"], Z, w["loss.temp"], q)
        names = list(w)
        grads = dict(zip(names, torch.autograd.grad(loss, [w[k] for k in names],
                                                    allow_unused=True)))
        grads = {k: torch.zeros_like(w[k]) if g is None else g
                 for k, g in grads.items()}
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: _norm(g) for k, g in grads.items()}
        with torch.no_grad():
            c1, c2 = 1 - ADAM_B1 ** i, 1 - ADAM_B2 ** i
            for k, g in grads.items():
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * g * g + ADAM_B2 * nu[k]
                u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + ADAM_EPS)
                w[k] -= lr * u
    end = {**{k: v.detach() for k, v in w.items()}, **running}
    return {"losses": losses, "grad_norms": first_grads,
            "change_norms": {k: _norm(end[k] - start[k]) for k in start}}


@torch.no_grad()
def serve(weights: dict, running: dict, X, subjects, model: dict, loc, cos,
          sin, collate_cfg: dict, q):
    """The served forward: collate, then the encoder in eval mode."""
    X = collate(X, collate_cfg["baseline_len_samp"], collate_cfg["clamp_lim"])
    Z, _ = forward(weights, running, X, subjects, loc, cos, sin,
                   num_blocks=model["num_blocks"], seq2seq=model["seq2seq"],
                   train=False, q=q)
    return Z
