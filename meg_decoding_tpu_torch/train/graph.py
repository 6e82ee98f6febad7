"""Programs captured as CUDA graphs and replayed on the card: the port's
counterpart of JAX's compiled programs.

* ``train``: the train step, ``jax.jit(train_step)``
  (``meg_decoding_tpu/train/steps.py:257``), also on a spilled set and
  over a data-parallel mesh (``meg_decoding_tpu/train/scan_loop.py:232,
  267``), and, replayed ``updates`` times, ``_build_epoch``'s
  ``lax.scan`` (``meg_decoding_tpu/train/scan_loop.py:291-326``).
* ``forward``: the programs that only read: ``jax.jit(eval_step)``
  (``meg_decoding_tpu/train/steps.py:301``), the eval CLIs' ``jax.jit(fwd)``
  (``meg_decoding_tpu/cli/evaluate_speech.py:67-75``,
  ``meg_decoding_tpu/cli/evaluate_god.py:60-68``) and the served artifact,
  whose ``Exported.call`` compiles once per batch size
  (``meg_decoding_tpu/serving/export.py:145-163``).

Eagerly the host issues every operation of a program (~2,300–2,600 a train
step on the card); replayed, it issues one graph launch plus the copies of
the inputs into the graph's static buffers.  ``GraphedStep`` wraps a
program's device part, which reads nothing back to the host and copies
nothing from it: a ``TrainStep``'s ``body(state, **inputs) → metrics``
(``train/steps.py``), which writes the state in place, or a forward body
``body(**inputs) → outputs``, which writes nothing.  The host part (the
step's draws, a request's casts) runs before each call.

A train step keeps one input signature (structure, shapes, dtypes): a
changed one raises.  A forward has one graph per input signature, captured
at the first call with it, as ``jax.jit`` compiles once per shape; the
graphs of one ``GraphedStep`` share one memory pool, which is safe because
their replays run one after another on one stream and each call copies
its outputs out before the next replay.

The first call of a signature allocates its static input buffers, runs the
body ``WARMUP`` times on a side stream (the autograd engine, cuDNN and
cuBLAS set up their workspaces there, as ``torch.cuda.graph`` requires),
then captures one body.  For a train step it first saves, and after the
warm-up puts back, every tensor of the state (parameters, Adam's moments
and count, the BN buffers, the step counter); for a forward it checks that
the warm-up left the tensors it ``reads`` bit-equal, and raises otherwise,
and puts back the tensors it ``writes`` in place from one call to the next
(a model's state carried from chunk to chunk), so that the warm-up leaves
no trace and the replay after the capture runs on what the call before
left.
The kernels' launch counters are put back as they were before the warm-up.
Each call copies the inputs in (device inputs device to device; host
inputs through a pinned buffer, without a sync), replays, credits the
kernels' launch counters (``ops/kernels/__init__.py``) with the launches
the capture recorded (a replay does not run the wrappers' Python, and
``chip_smoke.py`` checks the counts), and returns a copy of the outputs (any pytree of tensors; the
0-dim ones of one dtype copied out in one operation), so that no two
calls' outputs share storage.  The captured pointers are the caller's own
tensors (the state's, the model's): a caller that rebinds one instead of
writing it in place (as ``TrainState.load_state_dict`` and
``load_state_dict`` do) needs a new ``GraphedStep``.

A replay runs what its capture ran, whatever Python flags say now: a
forward body captured with ``model.eval()`` stays an eval-mode forward,
and a train body captured with ``model.train()`` a training step.

Every route takes its graph: the device-resident and the spilled train
sets alike (a spilled set's batches arrive as device tensors from the
prefetch's side stream, ``data/prefetch.py``, and are copied device to
device into the static inputs on the compute stream, after its wait on
the copy's event), and the data-parallel steps, test pools and epochs.
A body under a data-parallel ``mesh`` (``core/mesh.py``) holds NCCL
collectives: ``c10d``'s all-reduce, all-gather and reduce-scatter, also
inside autograd's backward (``torch.distributed.nn.functional``, the
synced BatchNorm's backward).  NCCL joins its internal stream to the
captured one through events, so the collectives are recorded in the
graph and a replay issues them with no host work.  The warm-up runs them
on every rank in the same order (it also makes the communicator before
the capture), and every rank's capture records the same sequence.  Before
the first capture under a mesh the group's backend must be NCCL, at
least 2.9.6 (the first that supports stream capture); otherwise it
raises.  The capture's error mode is thread-local: the calls of other
threads (the prefetch's copies, NCCL's watchdog, which polls the events
of eager collectives) neither fail nor spoil it, while an unsafe call of
the capturing thread (a read back to the host) still fails it.

Each call's phases are spans (``utils/profiling.py``): ``graph.copy_in``
(with ``graph.wait_staged`` and ``graph.stage_pinned``),
``graph.replay`` (``graph=`` the id of the program's capture table) and
``graph.copy_out``.  Each capture records the program's
``CaptureTable``: its nodes in replay order, each put down to the module
scope that added it (``profiling.scope``); on the CPU the first eager run
records the scopes' order.

On the CPU it runs the body eagerly on the same static buffers, so that
the tests here exercise the copy-in and copy-out (under a gloo group,
its collectives too).  A failed capture raises; there is no eager
fallback.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.ops.kernels import add_counts, launch_counts
from meg_decoding_tpu_torch.utils.profiling import capture_table, span

__all__ = ["GraphedStep", "WARMUP", "KINDS", "NCCL_CAPTURE", "replays",
           "captures", "reset_counts", "launch_counts", "state_tensors"]

WARMUP = 3
KINDS = ("train", "forward")
NCCL_CAPTURE = (2, 9, 6)  # the first NCCL whose collectives a capture records

# replays and captures by kind since the last reset_counts(), over every
# GraphedStep (read by chip_smoke.py to show that a path ran its graphs)
replays = dict.fromkeys(KINDS, 0)
captures = dict.fromkeys(KINDS, 0)


def reset_counts() -> None:
    for kind in KINDS:
        replays[kind] = captures[kind] = 0


def state_tensors(state) -> list:
    """Every tensor a step writes: parameters (the temperature among
    them), Adam's moments and count, the model's buffers, the step."""
    opt = state.opt_state
    return [*state.params().values(), *opt.mu.values(), *opt.nu.values(),
            opt.count, *state.model.buffers(), state.step]


def _signature(leaves: list) -> tuple:
    return tuple(None if t is None else (tuple(t.shape), t.dtype)
                 for t in leaves)


class _Program:
    """One input signature (``key``): its static and pinned input buffers,
    its graph, the launches its capture recorded and its capture table
    (``utils/profiling.py``), and the body's outputs on the static inputs
    (``leaves`` under ``spec``; the 0-dim leaves of one dtype, at
    ``scalars``, also stacked into ``stacked``)."""

    def __init__(self, key, leaves: list, device: torch.device):
        self.key = key
        self.table = None
        self.static = [None if t is None else
                       torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in leaves]
        self.pinned = [None] * len(leaves)
        self.graph = None
        self.delta = {}
        self.spec = self.leaves = self.scalars = self.stacked = None

    def keep(self, out) -> None:
        self.leaves, self.spec = tree_flatten(out)
        scalars = [i for i, t in enumerate(self.leaves)
                   if t is not None and t.dim() == 0]
        if len({self.leaves[i].dtype for i in scalars}) > 1:
            scalars = []
        self.scalars = scalars
        self.stacked = (torch.stack([self.leaves[i] for i in scalars])
                        if scalars else None)

    def copy_out(self):
        leaves = list(self.leaves)
        if self.scalars:
            flat = self.stacked.clone()
            for j, i in enumerate(self.scalars):
                leaves[i] = flat[j]
        scalars = set(self.scalars)
        for i, t in enumerate(self.leaves):
            if i not in scalars and t is not None:
                leaves[i] = t.clone()
        return tree_unflatten(leaves, self.spec)


class GraphedStep:
    """``graphed(inputs) → outputs``: the body replayed as a CUDA graph on
    the card (module docstring), eagerly on the CPU.  ``inputs`` is a dict
    of tensors (nested dicts and tuples, None leaves allowed).

    With a ``state`` (a train state), ``body(state, **inputs)`` is a train
    step: kind ``"train"``, one input signature, on the state's device.
    Without one, ``body(**inputs)`` is a forward: kind ``"forward"``, one
    graph per input signature, on ``device``; ``reads`` are tensors the
    body reads (the weights), checked unchanged by each capture's warm-up;
    ``writes`` are tensors it updates in place from call to call, put back
    after each capture's warm-up.
    ``capture_seconds`` is the last warm-up and capture's wall time, None
    before the first capture on the card; ``programs`` maps each signature
    seen to its buffers and graph.  ``mesh``: the data-parallel mesh whose
    collectives the body issues, or None."""

    def __init__(self, body, state=None, device="cuda", reads=(), mesh=None,
                 writes=()):
        self.body, self.state, self.mesh = body, state, mesh
        self.kind = "forward" if state is None else "train"
        # raises for a CUDA device on a machine without a card
        self.device = resolve_device(device if state is None
                                     else state.step.device)
        self.reads, self.writes = list(reads), list(writes)
        self.capture_seconds = None
        self.programs: dict = {}
        self._pool = None     # the graphs' shared memory pool
        self._staged = None   # event after the last copies out of a pinned buffer

    def __call__(self, inputs: dict):
        leaves, spec = tree_flatten(inputs)
        prog = self._program(leaves, spec)
        with span("graph.copy_in"):
            self._copy_in(prog, leaves)
        if self.device.type != "cuda":
            if prog.table is None:
                # the first run records the scopes, as a capture does
                self._record(prog, spec)
            else:
                with span("graph.replay", "graph", prog.table.id):
                    self._run(prog, spec)
        else:
            if prog.graph is None:
                self._capture(prog, spec)
            with span("graph.replay", "graph", prog.table.id):
                prog.graph.replay()
            add_counts(prog.delta)
            replays[self.kind] += 1
        with span("graph.copy_out"):
            return prog.copy_out()

    def _program(self, leaves: list, spec) -> _Program:
        key = (spec, _signature(leaves))
        prog = self.programs.get(key)
        if prog is not None:
            return prog
        if self.kind == "train" and self.programs:
            (spec0, _), prog0 = next(iter(self.programs.items()))
            if spec != spec0:
                raise ValueError("a GraphedStep's inputs keep one structure: "
                                 f"{spec} after {spec0}")
            for t, static in zip(leaves, prog0.static):
                if (t is None) != (static is None):
                    raise ValueError("a GraphedStep input is None on one call "
                                     "and a tensor on another")
                if t is not None and (t.shape != static.shape
                                      or t.dtype != static.dtype):
                    raise ValueError(
                        f"a GraphedStep input changed from "
                        f"{tuple(static.shape)} {static.dtype} to "
                        f"{tuple(t.shape)} {t.dtype}")
        prog = self.programs[key] = _Program(key, leaves, self.device)
        return prog

    def _copy_in(self, prog: _Program, leaves: list) -> None:
        if self._staged is not None:
            # the last call's copies out of the pinned buffers are done
            with span("graph.wait_staged"):
                self._staged.synchronize()
            self._staged = None
        staged = False
        for i, (t, static) in enumerate(zip(leaves, prog.static)):
            if t is None:
                continue
            if self.device.type == "cuda" and t.device.type == "cpu":
                if prog.pinned[i] is None:
                    prog.pinned[i] = torch.empty(t.shape, dtype=t.dtype,
                                                 pin_memory=True)
                with span("graph.stage_pinned"):
                    prog.pinned[i].copy_(t)
                static.copy_(prog.pinned[i], non_blocking=True)
                staged = True
            else:
                static.copy_(t, non_blocking=True)
        if staged:
            self._staged = torch.cuda.Event()
            self._staged.record()

    def _run(self, prog: _Program, spec) -> None:
        """The body on the static buffers; its outputs kept on ``prog``."""
        inputs = tree_unflatten(prog.static, spec)
        prog.keep(self.body(**inputs) if self.state is None
                  else self.body(self.state, **inputs))

    def _record(self, prog: _Program, spec) -> None:
        """``_run`` with its capture table recorded (on the card inside the
        capture)."""
        with capture_table(self.kind, prog.key) as table:
            self._run(prog, spec)
        prog.table = table

    def _check_collectives(self) -> None:
        """A body under a mesh is captured only over NCCL that records its
        collectives in a capture."""
        backend = dist.get_backend(self.mesh.group)
        if backend != "nccl":
            raise RuntimeError(f"a data-parallel body is captured over NCCL, "
                               f"not {backend}")
        version = tuple(torch.cuda.nccl.version()[:3])
        if version < NCCL_CAPTURE:
            raise RuntimeError(f"NCCL {version} cannot record collectives in a "
                               f"CUDA graph; {NCCL_CAPTURE} or later can")

    def _capture(self, prog: _Program, spec) -> None:
        if self.mesh is not None:
            self._check_collectives()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        counts = launch_counts()
        watched = (self.reads if self.state is None
                   else state_tensors(self.state))
        with torch.no_grad():
            saved = [t.clone() for t in watched]
            carried = [t.clone() for t in self.writes]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self._run(prog, spec)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            if self.state is not None:
                for t, s in zip(watched, saved):
                    t.copy_(s)
            elif not all(torch.equal(t, s) for t, s in zip(watched, saved)):
                raise RuntimeError("a forward body wrote a tensor it reads")
            for t, s in zip(self.writes, carried):
                t.copy_(s)
        del saved, carried
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            self._record(prog, spec)
        self._pool = graph.pool()
        after = launch_counts()
        prog.delta = {k: after[k] - before[k] for k in after}
        # neither the warm-up nor the capture counts as launches on the
        # card's path: each replay does
        add_counts({k: counts[k] - after[k] for k in after})
        prog.graph = graph
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        captures[self.kind] += 1
