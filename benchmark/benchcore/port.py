"""The program under test, ``meg_decoding_tpu_torch``, as the cells drive
it: its entry points, its launch and replay counters.  The only module of
the benchmark that imports the program.

* ``Trainer``: the train step as ``fit`` runs it
  (``train/loop.py:train_route``, a ``GraphedStep`` replay): for speech
  the fused step (``train/scan_loop.py:make_fused_speech_step``: session
  and segment draws, two window gathers, the collate from percentiles or
  from the swept table, the encoder, CLIP loss, Adam, BN running
  statistics); for GOD ``train/steps.py:make_train_step`` after the
  packed set's gather (``data/packed.py:PackedDataset.gather``).
* ``Server``: ``serving/export.py:make_serving_forward``'s forward
  graph (collate and eval-mode encoder).

Weights come from the benchmark (``benchcore/data.py``) and are copied
into the program's model in place before anything is captured.
"""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    compute_collate_stats,
)
from meg_decoding_tpu_torch.data.packed import PackedDataset
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.serving.export import make_serving_forward
from meg_decoding_tpu_torch.train import graph as graph_mod
from meg_decoding_tpu_torch.train.loop import train_route
from meg_decoding_tpu_torch.train.optim import B1
from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import TEMP, create_train_state
from meg_decoding_tpu_torch.train.steps import (
    CollateConfig,
    LossConfig,
    make_train_step,
)

__all__ = ["device", "build_kernels", "counters", "Trainer", "Server"]

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def device(name: str) -> torch.device:
    """The program's device resolution (TF32 off on the card)."""
    return resolve_device(name)


def build_kernels() -> float:
    """Builds (first run in a checkout) or finds the program's CUDA
    kernels under its build directory; returns the seconds it took."""
    return build.build()["seconds"]


def counters() -> dict:
    """Graph replays by kind and every kernel launch counter, flat."""
    out = {f"replays.{k}": v for k, v in graph_mod.replays.items()}
    for (mod, attr, key), n in graph_mod.launch_counts().items():
        out[".".join(p for p in (mod, attr, key) if p)] = n
    return out


def _model(cfg: dict, mix: dict, loc: np.ndarray, dev) -> BrainEncoder:
    m = cfg["model"]
    return BrainEncoder(loc, cfg["data"]["subjects"], D1=m["D1"], D2=m["D2"],
                        F=m["F"], K=m["K"], d_drop=m["d_drop"],
                        seq2seq=m["seq2seq"], num_blocks=m["num_blocks"],
                        dtype=_DTYPES[mix["compute_dtype"]],
                        gelu_impl=mix["gelu_impl"], device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))


@torch.no_grad()
def _load(model: BrainEncoder, weights: dict, running: dict | None) -> None:
    params = dict(model.named_parameters())
    want = set(weights) - {TEMP}
    if set(params) != want:
        raise KeyError(f"weights and model differ: {sorted(set(params) ^ want)}")
    for name, p in params.items():
        p.copy_(weights[name])
    if running is not None:
        buffers = dict(model.named_buffers())
        for name, t in running.items():
            buffers[name].copy_(t)


def _collate(cfg: dict) -> CollateConfig:
    c = cfg["collate"]
    return CollateConfig(baseline_len_samp=c["baseline_len_samp"],
                         clamp_lim=c["clamp_lim"])


class Trainer:
    """``trainer(draw) → metrics`` (0-dim device tensors): one train step
    of the cell on ``draw`` (``idx``: segment ids or packed rows,
    ``sess``: sessions, speech only, ``centre``: the dropout sensor)."""

    def __init__(self, cfg: dict, mix: dict, data, weights: dict,
                 loc: np.ndarray, dev):
        model = _model(cfg, mix, loc, dev)
        _load(model, weights, None)
        opt = make_optimizer(Config({"lr": cfg["optimizer"]["lr"],
                                     "epochs": 1}), 1)
        state = create_train_state(model, opt)
        with torch.no_grad():
            state.temp.copy_(weights[TEMP])
        self.model, self.state = model, state
        self.speech = cfg["dataset"] == "speech"
        collate = _collate(cfg)
        if self.speech:
            W = data.words
            packed = GwilliamsPacked(
                recordings=data.recordings, y_stream=data.y_stream,
                meg_onsets=data.meg_onsets, speech_onsets=data.speech_onsets,
                n_words=np.full(data.recordings.shape[1], W),
                session_subject=data.session_subject, seq_len=data.seq_len,
                num_subjects=data.num_subjects)
            stats = (compute_collate_stats(packed, collate.baseline_len_samp)
                     if mix["collate"] == "cached" else None)
            step = make_fused_speech_step(model, opt, LossConfig(kind="clip"),
                                          collate, packed, collate_stats=stats)
        else:
            self.train_set = PackedDataset(
                X=data.X, Y=data.Y, subject_idxs=data.subjects,
                labels=data.labels, num_subjects=data.num_subjects)
            step = make_train_step(model, opt,
                                   LossConfig(kind="clip", label_offset=1),
                                   collate)
        self.route = train_route(step, state)

    def __call__(self, draw: dict):
        if self.speech:
            return self.route(draw["idx"], sess_ids=draw["sess"],
                              centre=draw["centre"])
        X, Y, subs = self.train_set.gather(draw["idx"])[:3]
        return self.route(X, Y, subs, centre=draw["centre"])

    def leaves(self) -> dict:
        """Every trained tensor and the BN running statistics, by the
        reference's names."""
        out = dict(self.state.params())
        for name, t in self.model.named_buffers():
            if name.endswith((".mean", ".var")):
                out[name] = t
        return out

    def first_gradients(self) -> dict:
        """After one step from a fresh state: each leaf's gradient as Adam
        got it, ``mu / (1 − b1)``."""
        return {k: v / (1 - B1) for k, v in self.state.opt_state.mu.items()}


class Server:
    """``server(X, subjects) → Z``: one request through the serving
    forward's graph (X raw windows, on the host)."""

    def __init__(self, cfg: dict, mix: dict, weights: dict, running: dict,
                 loc: np.ndarray, dev):
        self.model = _model(cfg, mix, loc, dev)
        _load(self.model, weights, running)
        self.forward = make_serving_forward(_collate(cfg))

    def __call__(self, X, subjects):
        return self.forward(self.model, X, subjects)
