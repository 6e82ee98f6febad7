"""The inputs a cell runs on, made from ``--seed``: the data sets, the
initial weights, the sensor positions and the random draws.  Both the
program and the reference get these same tensors.

Frozen copies: the speech set is ``meg_decoding_tpu_torch/cli/bench.py:
make_synthetic_packed``'s (Gwilliams2022 at the dataset's full scale, on
the device in two ``randn`` calls, every session on its task's onsets),
seeded by ``--seed``; the sensor layouts are ``data/layout.py``'s
``synthetic_cap_locations`` and ``normalize_locations``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchcore.counts import pad_time_for_gather

__all__ = ["seed_of", "np_rng", "torch_gen", "SpeechData", "GodData",
           "make_data", "make_weights", "make_running", "sensor_locations"]


def seed_of(seed: int, *path: str) -> int:
    """A 63-bit seed derived from ``--seed`` (any whole number) and a path
    of names, one stream per use."""
    words = [int(seed) % 2**64] + [int.from_bytes(p.encode(), "little")
                                   for p in path]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


def np_rng(seed: int, *path: str) -> np.random.Generator:
    return np.random.default_rng(seed_of(seed, *path))


def torch_gen(device, seed: int, *path: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *path))


@dataclass
class SpeechData:
    """The packed Gwilliams set: recordings (S, 4, C, Tp) f32, the
    embedding streams (4, F, Tp) f32, each (session, task)'s word onsets
    (S, 4, W) int32 and the streams' (4, W) int32, the subject of each
    session (S,) int64; a segment id g is task g // W, word g % W."""
    recordings: torch.Tensor
    y_stream: torch.Tensor
    meg_onsets: torch.Tensor
    speech_onsets: torch.Tensor
    session_subject: torch.Tensor
    words: int
    seq_len: int
    num_subjects: int

    @property
    def segments(self) -> int:
        return self.recordings.shape[1] * self.words

    @property
    def sessions(self) -> int:
        return self.recordings.shape[0]


@dataclass
class GodData:
    """The packed GOD train split: epochs X (N, C, T), CLIP targets Y
    (N, F), subjects (N,) int64, image labels (N,) int64 (1-indexed), and
    the rows the cross-validation split trains on."""
    X: torch.Tensor
    Y: torch.Tensor
    subjects: torch.Tensor
    labels: torch.Tensor
    train_rows: np.ndarray
    num_subjects: int


def _speech(cfg: dict, seed: int, device) -> SpeechData:
    d, m = cfg["data"], cfg["model"]
    rate = int(d["rate"])
    T = int(d["rec_sec"] * rate)
    L = int(d["seq_len_sec"] * rate)
    Tp = pad_time_for_gather(T, L)
    S = d["subjects"] * d["sessions_per_subject"]
    tasks, W = d["tasks"], d["words_per_task"]
    gen = torch_gen(device, seed, "recordings")
    recordings = torch.randn((S, tasks, m["C"], Tp), generator=gen,
                             device=device)
    y_stream = torch.randn((tasks, m["F"], Tp), generator=gen, device=device)
    onsets = np.sort(np_rng(seed, "onsets").integers(0, T - L, size=(tasks, W)),
                     axis=1).astype(np.int32)
    meg = np.ascontiguousarray(np.broadcast_to(onsets[None], (S, tasks, W)))
    subject = np.repeat(np.arange(d["subjects"]), d["sessions_per_subject"])
    as_dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return SpeechData(recordings, y_stream, as_dev(meg), as_dev(onsets),
                      as_dev(subject.astype(np.int64)), W, L, d["subjects"])


def _god(cfg: dict, seed: int, device) -> GodData:
    d, m = cfg["data"], cfg["model"]
    N = d["train_sessions"] * d["trials_per_session"]
    gen = torch_gen(device, seed, "epochs")
    X = torch.randn((N, m["C"], d["T"]), generator=gen, device=device)
    Y = torch.randn((N, m["F"]), generator=gen, device=device)
    subjects = torch.zeros(N, dtype=torch.int64, device=device)
    labels = torch.arange(1, N + 1, dtype=torch.int64, device=device)
    return GodData(X, Y, subjects, labels, np.arange(d["cv_train_rows"]),
                   d["subjects"])


def make_data(cfg: dict, seed: int, device):
    """The configuration's data set (``cfg["dataset"]``: speech or god)."""
    return {"speech": _speech, "god": _god}[cfg["dataset"]](cfg, seed, device)


def make_weights(spec: list, init_temperature: float, seed: int,
                 device) -> dict:
    """Every trained tensor of ``spec`` (``reference.model.param_spec``)
    from one ``rand`` call on the device, and ``loss.temp``."""
    sizes = [int(np.prod(shape)) for _, shape, init in spec
             if init[0] == "uniform"]
    u = torch.rand(sum(sizes), generator=torch_gen(device, seed, "weights"),
                   device=device)
    out, at = {}, 0
    for name, shape, init in spec:
        if init[0] == "uniform":
            n = int(np.prod(shape))
            lo, hi = init[1], init[2]
            out[name] = (lo + (hi - lo) * u[at:at + n]).view(shape)
            at += n
        else:
            out[name] = torch.full(shape, float(init[1]), device=device)
    out["loss.temp"] = torch.tensor(float(init_temperature), device=device)
    return out


def make_running(spec: list, seed: int, device) -> dict:
    """BatchNorm running statistics of a trained model
    (``reference.model.buffer_spec``): means N(0, 0.1²), variances
    U[0.5, 1.5)."""
    gen = torch_gen(device, seed, "running")
    out = {}
    for name, shape in spec:
        if name.endswith(".mean"):
            out[name] = 0.1 * torch.randn(shape, generator=gen, device=device)
        else:
            out[name] = 0.5 + torch.rand(shape, generator=gen, device=device)
    return out


def _normalize(loc: np.ndarray) -> np.ndarray:
    """Each axis min-max normalised into [0.1, 0.9]."""
    loc = np.asarray(loc, dtype=np.float32)
    loc = (loc - loc.min(axis=0)) / (loc.max(axis=0) - loc.min(axis=0))
    return (loc * 0.8 + 0.1).astype(np.float32)


def _synthetic_cap(n: int) -> np.ndarray:
    """A sunflower spiral of ``n`` points on the unit disc."""
    idx = np.arange(n, dtype=np.float64) + 0.5
    r = np.sqrt(idx / n)
    theta = idx * (np.pi * (3.0 - np.sqrt(5.0)))
    return np.stack([r * np.cos(theta), r * np.sin(theta)],
                    axis=1).astype(np.float32)


def sensor_locations(cfg: dict) -> np.ndarray:
    """(C, 2) normalised sensor positions: the configuration's
    ``sensor_xy``, else a synthetic cap of C sensors."""
    xy = cfg.get("sensor_xy")
    if xy is None:
        return _normalize(_synthetic_cap(cfg["model"]["C"]))
    return _normalize(np.asarray(xy, dtype=np.float32))
