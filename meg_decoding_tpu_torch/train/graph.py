"""The train step as one captured CUDA graph: the port's counterpart of
``jax.jit(train_step)`` (``meg_decoding_tpu/train/steps.py:257``) and,
replayed ``updates`` times, of ``_build_epoch``'s ``lax.scan``
(``meg_decoding_tpu/train/scan_loop.py:291-326``).

Eagerly the host issues every operation of a step (~2,300–2,600 a step on
the card); replayed, it issues one graph launch plus the copies of the
step's inputs into the graph's static buffers.  ``GraphedStep`` wraps a
``TrainStep``'s device part (``train/steps.py``: ``body(state, **inputs)
→ metrics``), which reads nothing back to the host and copies nothing from
it; the step's host part (its draws) runs before each replay.

On the first call it allocates the static input buffers, runs the body
``WARMUP`` times on a side stream (the autograd engine, cuDNN and cuBLAS
set up their workspaces there, as ``torch.cuda.graph`` requires), puts
back every tensor of the state the warm-up moved (parameters, Adam's
moments and count, the BN buffers, the step counter) and the kernels'
launch counters, then captures one body.  Each call copies the inputs in
(device inputs device to device; host inputs through a pinned buffer,
without a sync), replays, credits the kernels' launch counters with the
launches the capture recorded (a replay does not run the wrappers' Python,
and ``chip_smoke.py`` checks the counts), and returns a copy of the
metrics, so that no two steps' metrics share storage.  The captured
pointers are the state's own tensors: a caller that rebinds one (instead
of writing it in place, as ``TrainState.load_state_dict`` does) needs a new
``GraphedStep``.

On the CPU it runs the body eagerly on the same static buffers, so that
the tests here exercise the copy-in and copy-out.  A failed capture
raises; there is no eager fallback.
"""

from __future__ import annotations

import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.ops.kernels import (
    batchnorm,
    quantile,
    window_gather,
)

__all__ = ["GraphedStep", "WARMUP", "replays", "captures", "reset_counts",
           "launch_counts"]

WARMUP = 3

# replays and captures since the last reset_counts(), over every
# GraphedStep (read by chip_smoke.py to show that training ran the graph)
replays = 0
captures = 0

# the kernels' launch counters: (module, attribute), each an int or a dict
# of ints
_COUNTERS = ((window_gather, "launches"), (quantile, "launches"),
             (quantile, "long_launches"), (batchnorm, "launches"),
             (batchnorm, "stats_route_launches"),
             (batchnorm, "sums_only_launches"), (batchnorm, "dx_launches"))


def reset_counts() -> None:
    global replays, captures
    replays = captures = 0


def launch_counts() -> dict:
    """Every kernel launch counter, by (module name, attribute, key or
    None)."""
    out = {}
    for mod, attr in _COUNTERS:
        name, v = mod.__name__.rsplit(".", 1)[1], getattr(mod, attr)
        if isinstance(v, dict):
            out.update({(name, attr, k): n for k, n in v.items()})
        else:
            out[(name, attr, None)] = v
    return out


def _add_counts(delta: dict) -> None:
    mods = {mod.__name__.rsplit(".", 1)[1]: mod for mod, _ in _COUNTERS}
    for (name, attr, key), n in delta.items():
        if n == 0:
            continue
        m = mods[name]
        if key is None:
            setattr(m, attr, getattr(m, attr) + n)
        else:
            getattr(m, attr)[key] += n


def _state_tensors(state) -> list:
    """Every tensor a step writes: parameters (the temperature among
    them), Adam's moments and count, the model's buffers, the step."""
    opt = state.opt_state
    return [*state.params().values(), *opt.mu.values(), *opt.nu.values(),
            opt.count, *state.model.buffers(), state.step]


class GraphedStep:
    """``graphed(inputs) → metrics``: ``body(state, **inputs)`` replayed as
    one CUDA graph on the card (module docstring), eagerly on the CPU.
    ``inputs`` is a dict of tensors (nested dicts and tuples, None leaves
    allowed) of the same structure, shapes and dtypes on every call.
    ``capture_seconds`` is the warm-up and capture's wall time, None
    before the first call on the card."""

    def __init__(self, body, state):
        self.body, self.state = body, state
        # raises for a CUDA state on a machine without a card
        self.device = resolve_device(state.step.device)
        self.graph = None
        self.capture_seconds = None
        self._spec = self._static = self._pinned = None
        self._staged = None   # event after the last copies out of _pinned
        self._delta = {}      # launches recorded by the capture
        self._keys = self._out = None

    def __call__(self, inputs: dict) -> dict:
        global replays
        leaves, spec = tree_flatten(inputs)
        if self._spec is None:
            self._allocate(leaves, spec)
        elif spec != self._spec:
            raise ValueError("a GraphedStep's inputs keep one structure: "
                             f"{spec} after {self._spec}")
        self._copy_in(leaves)
        if self.device.type != "cuda":
            self._run()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            _add_counts(self._delta)
            replays += 1
        flat = self._out.clone()
        return {k: flat[i] for i, k in enumerate(self._keys)}

    def _allocate(self, leaves: list, spec) -> None:
        self._spec = spec
        self._static, self._pinned = [], []
        for t in leaves:
            if t is None:
                self._static.append(None)
                self._pinned.append(None)
                continue
            self._static.append(torch.empty(t.shape, dtype=t.dtype,
                                            device=self.device))
            host = self.device.type == "cuda" and t.device.type == "cpu"
            self._pinned.append(torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True) if host else None)

    def _copy_in(self, leaves: list) -> None:
        if self._staged is not None:
            # the last call's copies out of the pinned buffers are done
            self._staged.synchronize()
        staged = False
        for t, static, pinned in zip(leaves, self._static, self._pinned):
            if (t is None) != (static is None):
                raise ValueError("a GraphedStep input is None on one call "
                                 "and a tensor on another")
            if t is None:
                continue
            if t.shape != static.shape or t.dtype != static.dtype:
                raise ValueError(
                    f"a GraphedStep input changed from {tuple(static.shape)} "
                    f"{static.dtype} to {tuple(t.shape)} {t.dtype}")
            if pinned is not None and t.device.type == "cpu":
                pinned.copy_(t)
                static.copy_(pinned, non_blocking=True)
                staged = True
            else:
                static.copy_(t, non_blocking=True)
        if staged:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def _run(self) -> None:
        """The body on the static buffers; its metrics into one flat
        tensor, so that a call copies them out in one operation."""
        out = self.body(self.state, **tree_unflatten(self._static, self._spec))
        self._keys = tuple(out)
        self._out = torch.stack([out[k] for k in self._keys])

    def _capture(self) -> None:
        global captures
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        counts = launch_counts()
        with torch.no_grad():
            saved = [t.clone() for t in _state_tensors(self.state)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._run()
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(_state_tensors(self.state), saved):
                t.copy_(s)
        del saved
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._run()
        after = launch_counts()
        self._delta = {k: after[k] - before[k] for k in after}
        # neither the warm-up nor the capture counts as launches on the
        # card's path: each replay does
        _add_counts({k: counts[k] - after[k] for k in after})
        self.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        captures += 1
