"""The port's tracing: profiler traces, spans on the host path, step-phase
timing, and module scopes of the captured programs.  Port of
``meg_decoding_tpu/utils/profiling.py`` (``profile_trace``, ``StepTimer``),
extended.

* ``profile_trace`` — a context manager around ``torch.profiler`` (CPU
  activity, and CUDA activity when a GPU is present) that writes a Chrome
  trace of its window into a directory: the trainers' ``profile_dir`` and
  ``profile_epoch`` keys (``train/loop.py:fit``).
* ``span(name, key=None, value=None)`` — a named stretch of the host
  path.  While a ``torch.profiler`` session records (``profile_trace``,
  or any other), a span is one of the profiler's host ranges, labelled
  ``name#key=value`` (the id of its step or request); a span opened
  inside another is its child.  Its start and end are on the profiler's
  clock, with the device's kernels of the same trace.  It is a
  ``_RecordFunctionFast`` range, of the scope the profiler gives an aten
  operator, so it leaves nothing on the device's timeline: a
  ``record_function`` range (the user scope) would be mirrored there as a
  GPU annotation over the kernels it launched.  With no profiler and no
  ``StepTimer`` open, a span is two flag checks and a shared no-op
  context, and allocates nothing: no object that the cyclic collector
  counts (a ``**ids`` signature would build a dict at every call, and
  those allocations moved the collector's runs into the host path that
  GOD's step waits on, PERF.md).  The spans, each where its work
  happens:

  ==================== =====================================================
  ``train.step``       one ``train/loop.py:train_route`` call (``step=``)
  ``train.prepare``    its host draws (``TrainStep.prepare``)
  ``data.gather``      a train set's gather (``batch=``): ``PackedDataset``,
                       the speech pools
  ``data.upload_idx``  ``PackedDataset._take``'s copy of the indices to the
                       card (from pageable memory: it waits for the stream)
  ``graph.copy_in``    ``GraphedStep._copy_in``: the inputs into the static
                       buffers
  ``graph.wait_staged`` the wait for the last call's copies out of the
                       pinned buffers
  ``graph.stage_pinned`` a host input's copy into its pinned buffer
  ``graph.replay``     the graph's launch (``graph=`` its capture table's
                       id; on the CPU the body's eager run)
  ``graph.copy_out``   the copies of the outputs
  ``serve.request``    one ``serving/export.py:make_serving_forward`` call
                       (``request=``)
  ``w2v.embed``        one ``features/wav2vec.py:embed_last4_avg`` call
                       (``request=``)
  ``w2v.chunk``        one chunk's host work there: its buffer and mask,
                       the graph's call, the slice it keeps (``chunk=``)
  ``llm.embed``        one ``features/text_llm.py:embed_words_last4_avg``
                       call (``request=``)
  ``llm.chunk``        one chunk's host work there: its buffer, the graph's
                       call, the slice it keeps (``chunk=``)
  ==================== =====================================================

* ``StepTimer`` — host wall-clock time per phase, each phase the spans of
  one name, summed while the timer is open: ``fit``'s ``t_gather_ms``
  (``data.gather``) and ``t_step_ms`` (``train.step``).  Work on the card
  is asynchronous: a phase's time is the host's time to enqueue it,
  unless the span ends in a wait.
* ``scope(name)`` — marks a part of a body captured as a CUDA graph
  (``SCOPES``: the brain encoder's train and eval steps, then wav2vec2's
  chunk forward, ``features/wav2vec2_model.py``, then DeepSeek-V2's,
  ``features/deepseek_v2_model.py``, then Kimi-Linear's KDA layers,
  ``features/kimi_linear_model.py``).  Scopes nest; the innermost open scope owns the graph
  nodes its stretch adds.  While ``capture_table`` records, each scope
  boundary reads how many nodes the graph under capture holds (the CUDA
  driver's ``cuStreamGetCaptureInfo`` and ``cuGraphGetNodes``, which are
  allowed during a capture); otherwise a scope is one check.  A replay
  runs no scope code at all.
* ``capture_table(kind, signature)`` — records one captured program's
  ``CaptureTable``: its nodes in the order a replay runs them, each put
  down to the scope that owned it.  ``train/graph.py:GraphedStep`` opens
  it around each capture (on the CPU around the first eager run, which
  records the scopes' order alone).  ``tables`` keeps the last table of
  each (kind, signature) for the life of the process.
"""

from __future__ import annotations

import contextlib
import ctypes
import heapq
import itertools
import os
import threading
import time
from array import array
from collections import defaultdict
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["profile_trace", "span", "StepTimer", "batch_ids", "SCOPES",
           "scope", "CaptureTable", "capture_table", "tables"]

SCOPES = ("collate", "gelu", "batchnorm", "loss", "backward", "adam",
          "bn_commit", "w2v_conv", "w2v_pos_conv", "attention", "ffn",
          "last4", "mla", "moe_route", "moe_experts", "moe_shared", "kda")

# the ids of the train sets' gathers (``data.gather``'s ``batch=``)
batch_ids = itertools.count()

# (kind, signature) → the CaptureTable of its last capture
tables: dict = {}


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the window into ``log_dir/trace_<pid>_<n>.json`` (Chrome trace
    format, as ``torch.profiler`` exports it); does nothing when
    ``log_dir`` is None.  Yields the profiler (None when off)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


class _Off:
    """What a span or a scope is when nothing records: stateless, shared."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()
_timers: list = []  # the open StepTimers


def span(name: str, key: str | None = None, value=None):
    """A span of the host path (module docstring): ``with span(name,
    "step", n): ...``."""
    if not (_autograd_profiler._is_profiler_enabled or _timers):
        return _OFF
    return _Span(name, key, value)


class _Span:
    __slots__ = ("name", "key", "value", "_range", "_t0")

    def __init__(self, name: str, key, value):
        self.name, self.key, self.value = name, key, value
        self._range = self._t0 = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            label = (self.name if self.key is None
                     else f"{self.name}#{self.key}={self.value}")
            self._range = _RecordFunctionFast(label)
            self._range.__enter__()
        if _timers:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if self._t0 is not None:
            seconds = time.perf_counter() - self._t0
            for timer in tuple(_timers):
                timer.add(self.name, seconds)


class StepTimer:
    """Host wall-clock time per phase while the timer is open (``with
    timer:``): ``phases`` maps a span's name to its phase, and each span
    of that name that ends, in any thread, adds its time.  ``means_ms()``
    gives ``{"t_<phase>_ms": mean}`` over the phases seen."""

    def __init__(self, phases: dict):
        self.phases = dict(phases)
        self._acc = defaultdict(float)
        self._n = defaultdict(int)
        self._lock = threading.Lock()

    def __enter__(self):
        _timers.append(self)
        return self

    def __exit__(self, *exc):
        _timers.remove(self)

    def add(self, span_name: str, seconds: float) -> None:
        phase = self.phases.get(span_name)
        if phase is not None:
            with self._lock:
                self._acc[phase] += seconds
                self._n[phase] += 1

    def means_ms(self) -> dict:
        return {f"t_{k}_ms": 1e3 * self._acc[k] / max(self._n[k], 1)
                for k in self._acc}

    def reset(self) -> None:
        self._acc.clear()
        self._n.clear()


@dataclass
class CaptureTable:
    """One captured program's scopes.  ``entries``: the scopes in the
    order the body entered them.  On the card also ``rows``: ``(scope,
    first node, node count)`` over the graph's kernel, memcpy and memset
    nodes in the order a replay runs them, ``scope`` None for nodes
    outside every scope; ``types``: a letter a node (``K`` kernel, ``C``
    memcpy, ``S`` memset); ``counts``: nodes by scope; ``total``: the
    nodes.  ``seconds``: the host time the node reads took; ``error``: why
    the nodes could not be read, where they could not."""
    id: int
    kind: str
    entries: list = field(default_factory=list)
    rows: list | None = None
    types: str | None = None
    counts: dict | None = None
    total: int | None = None
    seconds: float = 0.0
    error: str | None = None


_table_ids = itertools.count()
_recording = None  # the _Recorder of the capture in progress


def scope(name: str):
    """A part of a captured body (module docstring): ``with scope("adam"):
    ...``."""
    if _recording is None:
        return _OFF
    return _Scope(_recording, name)


class _Scope:
    __slots__ = ("rec", "name")

    def __init__(self, rec, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec.enter(self.name)

    def __exit__(self, exc_type, exc, tb):
        self.rec.exit()


@contextlib.contextmanager
def capture_table(kind: str, signature):
    """Records the ``CaptureTable`` of the body run inside (module
    docstring) and keeps it in ``tables`` under ``(kind, signature)``;
    yields it.  The node reads happen while the stream captures, so open
    it inside ``torch.cuda.graph``."""
    global _recording
    table = CaptureTable(next(_table_ids), kind)
    nodes = None
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        try:
            nodes = _GraphNodes(torch.cuda.current_stream().cuda_stream)
        except (OSError, AttributeError, RuntimeError) as e:
            table.error = f"{type(e).__name__}: {e}"
    rec = _Recorder(table, nodes)
    _recording = rec
    try:
        yield table
        rec.finish()
    finally:
        _recording = None
    tables[(kind, signature)] = table


class _Recorder:
    """The scopes open during one capture, and each graph node's owner:
    at every boundary the nodes added since the last one go to the
    innermost scope open over that stretch."""

    def __init__(self, table: CaptureTable, nodes):
        self.table, self.nodes = table, nodes
        self.stack: list = []
        self.owner: dict = {}  # node handle → scope or None
        self._seen = b""       # the handles at the last boundary
        self._boundary()

    def enter(self, name: str) -> None:
        self._boundary()
        self.stack.append(name)
        self.table.entries.append(name)

    def exit(self) -> None:
        self._boundary()
        self.stack.pop()

    def _boundary(self) -> None:
        if self.nodes is None:
            return
        t0 = time.perf_counter()
        try:
            now = self.nodes.handles()
        except RuntimeError as e:
            self._fail(e)
            return
        owner = self.stack[-1] if self.stack else None
        n = len(self._seen)
        if now[:n] == self._seen:  # nodes come in the order they were added
            new = array("Q", now[n:])
        else:
            new = [h for h in array("Q", now) if h not in self.owner]
        for h in new:
            self.owner[h] = owner
        self._seen = now
        self.table.seconds += time.perf_counter() - t0

    def _fail(self, e: Exception) -> None:
        self.table.error = f"{type(e).__name__}: {e}"
        self.nodes = None

    def finish(self) -> None:
        """The table's rows, from the nodes in the order a replay runs
        them (read before the capture ends)."""
        self._boundary()
        if self.nodes is None:
            return
        t0 = time.perf_counter()
        try:
            order = self.nodes.run_order()
        except RuntimeError as e:
            self._fail(e)
            return
        rows, types, counts = [], [], defaultdict(int)
        for i, (h, letter) in enumerate(order):
            owner = self.owner.get(h)
            types.append(letter)
            counts[owner] += 1
            if rows and rows[-1][0] == owner:
                rows[-1][2] += 1
            else:
                rows.append([owner, i, 1])
        t = self.table
        t.rows = [tuple(r) for r in rows]
        t.types, t.counts, t.total = "".join(types), dict(counts), len(order)
        t.seconds += time.perf_counter() - t0


_driver = None


def _cuda_driver():
    """The CUDA driver's graph queries through ctypes, bound once: the
    names (newest ABI first) that this driver exports."""
    global _driver
    if _driver is not None:
        return _driver
    lib = ctypes.CDLL("libcuda.so.1")
    P, S = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)

    def bind(name, *args):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(args), ctypes.c_int
        return fn

    d = {}
    if hasattr(lib, "cuStreamGetCaptureInfo_v3"):
        # (stream, status, id, graph, dependencies, edge data, count)
        d["info"] = bind("cuStreamGetCaptureInfo_v3", P,
                         ctypes.POINTER(ctypes.c_int), P,
                         ctypes.POINTER(P), P, P, S)
        d["info_v"] = 3
    else:
        d["info"] = bind("cuStreamGetCaptureInfo_v2", P,
                         ctypes.POINTER(ctypes.c_int), P,
                         ctypes.POINTER(P), P, S)
        d["info_v"] = 2
    d["nodes"] = bind("cuGraphGetNodes", P, P, S)
    d["type"] = bind("cuGraphNodeGetType", P, ctypes.POINTER(ctypes.c_int))
    if hasattr(lib, "cuGraphGetEdges_v2"):
        # (graph, from, to, edge data, count)
        d["edges"] = bind("cuGraphGetEdges_v2", P, P, P, P, S)
        d["edges_v"] = 2
    else:
        d["edges"] = bind("cuGraphGetEdges", P, P, P, S)
        d["edges_v"] = 1
    _driver = d
    return d


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned CUresult {rc}")


class _GraphNodes:
    """The graph that ``stream`` is capturing, read through the CUDA
    driver: its node handles and, at the end, its kernel, memcpy and
    memset nodes in the order a replay runs them."""

    # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    _OPS = {0: "K", 1: "C", 2: "S"}
    _ACTIVE = 1                      # CU_STREAM_CAPTURE_STATUS_ACTIVE

    def __init__(self, stream: int):
        d = self.d = _cuda_driver()
        status, graph = ctypes.c_int(), ctypes.c_void_p()
        args = [ctypes.c_void_p(stream), ctypes.byref(status), None,
                ctypes.byref(graph), None]
        if d["info_v"] == 3:
            args.append(None)
        _check(d["info"](*args, None), "cuStreamGetCaptureInfo")
        if status.value != self._ACTIVE or not graph.value:
            raise RuntimeError("the stream is not capturing")
        self.graph = graph

    def handles(self) -> bytes:
        """The graph's node handles, 8 bytes each."""
        n = ctypes.c_size_t(0)
        _check(self.d["nodes"](self.graph, None, ctypes.byref(n)),
               "cuGraphGetNodes")
        if n.value == 0:
            return b""
        buf = (ctypes.c_uint64 * n.value)()
        _check(self.d["nodes"](self.graph, buf, ctypes.byref(n)),
               "cuGraphGetNodes")
        return bytes(buf)[:8 * n.value]

    def _letter(self, handle: int):
        kind = ctypes.c_int()
        _check(self.d["type"](ctypes.c_void_p(handle), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        return self._OPS.get(kind.value)

    def run_order(self) -> list:
        """``(handle, letter)`` of the kernel, memcpy and memset nodes in
        a topological order of the graph's edges, ties broken by the order
        the nodes were added: the order a replay of a captured stream
        runs them."""
        handles = array("Q", self.handles())
        index = {h: i for i, h in enumerate(handles)}
        n = ctypes.c_size_t(0)
        edges = self.d["edges"]
        extra = [None] if self.d["edges_v"] == 2 else []
        _check(edges(self.graph, None, None, *extra, ctypes.byref(n)),
               "cuGraphGetEdges")
        src = (ctypes.c_uint64 * max(n.value, 1))()
        dst = (ctypes.c_uint64 * max(n.value, 1))()
        if extra:
            # CUgraphEdgeData, 8 bytes an edge: without it a graph with
            # programmatic (early-launch) edges refuses the query
            extra = [(ctypes.c_uint64 * max(n.value, 1))()]
        if n.value:
            _check(edges(self.graph, src, dst, *extra, ctypes.byref(n)),
                   "cuGraphGetEdges")
        after = defaultdict(list)
        waits = [0] * len(handles)
        for a, b in zip(src[:n.value], dst[:n.value]):
            after[index[a]].append(index[b])
            waits[index[b]] += 1
        ready = [i for i, w in enumerate(waits) if w == 0]
        heapq.heapify(ready)
        out = []
        while ready:
            i = heapq.heappop(ready)
            letter = self._letter(handles[i])
            if letter is not None:
                out.append((handles[i], letter))
            for j in after[i]:
                waits[j] -= 1
                if waits[j] == 0:
                    heapq.heappush(ready, j)
        if sum(waits):
            raise RuntimeError("the captured graph has a cycle")
        return out
