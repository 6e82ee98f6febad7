"""The port's tracing (``meg_decoding_tpu_torch/utils/profiling.py``) on
the CPU, at small shapes:

* with no profiler and no ``StepTimer`` open a span or a scope is the
  shared no-op, and nothing is timed;
* under ``torch.profiler`` the spans are host ranges that nest as the
  module lists them and carry the id of their step or request: GOD's
  gather and train step, the served request;
* ``fit``'s epoch row keeps ``t_gather_ms`` and ``t_step_ms``, read from
  the ``data.gather`` and ``train.step`` spans, and a ``profile_dir``
  trace holds the spans;
* a captured body's scopes: their entries in body order on the CPU's
  recorded eager run, and each graph node put down to the innermost scope
  open when it was added (the driver's node reads replaced by a fake).
"""

import json
import os
import threading
from array import array
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.data.packed import PackedDataset
from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
from meg_decoding_tpu_torch.serving.export import make_serving_forward
from meg_decoding_tpu_torch.train import loop
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import (
    CollateConfig,
    LossConfig,
    make_eval_step,
    make_train_step,
)
from meg_decoding_tpu_torch.utils import profiling

N, C, T, F, SUBJECTS, B = 24, 6, 16, 8, 2, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _god(gelu_impl="erf_poly", seed=0):
    """A small GOD-like packed set, encoder, state and train step."""
    rng = np.random.RandomState(seed)
    ds = PackedDataset(
        X=torch.from_numpy(rng.randn(N, C, T).astype(np.float32)),
        Y=torch.from_numpy(rng.randn(N, F).astype(np.float32)),
        subject_idxs=torch.from_numpy(rng.randint(0, SUBJECTS, N)).long(),
        num_subjects=SUBJECTS)
    model = BrainEncoder(rng.rand(C, 2), SUBJECTS, D1=8, D2=8, F=F, K=2,
                         num_blocks=1, gelu_impl=gelu_impl,
                         generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(Config({"lr": 1e-3, "epochs": 1}), 1)
    state = create_train_state(model, opt)
    collate = CollateConfig(baseline_len_samp=4)
    step = make_train_step(model, opt, LossConfig(), collate)
    return ds, model, opt, state, step, collate


def _events(prof) -> list:
    """``(span, ids, event)`` of the program's spans in a profile."""
    out = []
    for e in prof.events():
        base, _, rest = e.name.partition("#")
        if base in SPAN_NAMES:
            ids = dict(kv.split("=") for kv in rest.split(",") if kv)
            out.append((base, ids, e))
    return out


SPAN_NAMES = {"train.step", "train.prepare", "data.gather", "data.upload_idx",
              "graph.copy_in", "graph.wait_staged", "graph.stage_pinned",
              "graph.replay", "graph.copy_out", "serve.request"}


def _parent(e):
    """The innermost enclosing program span of event ``e``."""
    p = e.cpu_parent
    while p is not None and p.name.partition("#")[0] not in SPAN_NAMES:
        p = p.cpu_parent
    return None if p is None else p.name.partition("#")[0]


def test_spans_and_scopes_are_no_ops_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("train.step", "step", 3) is profiling._OFF
    assert profiling.span("graph.replay") is profiling._OFF
    assert profiling.scope("adam") is profiling._OFF
    ds, _, _, state, step, _ = _god()
    route = loop.train_route(step, state)
    timer = profiling.StepTimer({"train.step": "step"})  # never opened
    for i in range(3):
        X, Y, subs = ds.gather(np.arange(i, i + B))
        m = route(X, Y, subs)
    assert np.isfinite(float(m["loss"]))
    assert timer.means_ms() == {}
    # an open timer makes a span time itself, and only the phases it names
    with timer:
        s = profiling.span("train.step", "step", 0)
        assert s is not profiling._OFF
        with s:
            pass
        with profiling.span("data.gather"):
            pass
    assert set(timer.means_ms()) == {"t_step_ms"}
    assert profiling.span("train.step") is profiling._OFF


def test_spans_and_scopes_off_allocate_nothing_the_collector_counts():
    """Off, a span or a scope makes no object that the cyclic collector
    counts: such allocations in the step's host path move the collector's
    runs onto the path the card waits on."""
    import gc

    def calls(n):
        for i in range(n):
            with profiling.span("train.step", "step", i):
                with profiling.span("graph.copy_in"):
                    with profiling.scope("adam"):
                        pass

    calls(10)
    gc.collect()
    gc.disable()
    try:
        before = gc.get_count()[0]
        calls(1000)
        made = gc.get_count()[0] - before
    finally:
        gc.enable()
    # one container a call would be 3,000; the loop itself may make one
    assert made < 3, made


def test_spans_nest_and_carry_their_ids_under_the_profiler():
    ds, model, _, state, step, collate = _god()
    route = loop.train_route(step, state)
    forward = make_serving_forward(collate)
    X0, subs0 = ds.X[:2], ds.subject_idxs[:2]
    # the first calls record the programs' scopes (on the card: capture)
    route(*ds.gather(np.arange(B)))
    forward(model, X0, subs0)
    first_batch = next(profiling.batch_ids) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            route(*ds.gather(np.arange(i, i + B)))
        for i in range(2):
            forward(model, X0, subs0)
    ev = _events(prof)
    ids = {k: [d for b, d, _ in ev if b == k] for k in SPAN_NAMES}
    assert ids["train.step"] == [{"step": "1"}, {"step": "2"}]
    assert ids["serve.request"] == [{"request": "1"}, {"request": "2"}]
    assert ids["data.gather"] == [{"batch": str(first_batch)},
                                  {"batch": str(first_batch + 1)}]
    graph_ids = {d["graph"] for d in ids["graph.replay"]}
    known = {t.id: t.kind for t in profiling.tables.values()}
    assert len(graph_ids) == 2 and {known[int(g)] for g in graph_ids} == \
        {"train", "forward"}
    parents = {}
    for base, _, e in ev:
        parents.setdefault(base, set()).add(_parent(e))
    assert parents["data.upload_idx"] == {"data.gather"}
    assert parents["data.gather"] == {None}
    assert parents["train.prepare"] == {"train.step"}
    for child in ("graph.copy_in", "graph.replay", "graph.copy_out"):
        assert parents[child] == {"train.step", "serve.request"}, child
    # a step's phases in order: draws, copy in, replay, copy out
    step0 = next(e for b, d, e in ev if b == "train.step")
    kids = sorted((e for _, _, e in ev if e.cpu_parent is step0),
                  key=lambda e: e.time_range.start)
    assert [k.name.partition("#")[0] for k in kids] == [
        "train.prepare", "graph.copy_in", "graph.replay", "graph.copy_out"]


def test_fit_reads_its_phase_times_from_the_spans(tmp_path):
    ds, model, _, state, step, collate = _god()
    evaluate = make_eval_step(model, LossConfig(), collate)
    cfg = Config({"epochs": 2, "batch_size": B, "updates": 3,
                  "test_size": B, "profile_dir": str(tmp_path / "prof"),
                  "profile_epoch": 1})
    _, best = loop.fit(cfg, ds, ds, state, step, evaluate, None, seed=1)
    assert best["t_gather_ms"] > 0 and best["t_step_ms"] > 0
    assert best["t_step_ms"] > best["t_gather_ms"]
    assert not profiling._timers
    # the traced epoch's Chrome trace holds the spans
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    bases = {n.partition("#")[0] for n in names}
    assert {"train.step", "data.gather", "graph.replay"} <= bases
    steps = sorted(int(n.split("step=")[1]) for n in names
                   if n.startswith("train.step#"))
    assert steps == [3, 4, 5]


def test_step_timer_reads_spans_of_every_thread():
    timer = profiling.StepTimer({"data.gather": "gather"})

    def gathers():
        for _ in range(50):
            with profiling.span("data.gather"):
                pass

    with timer:
        threads = [threading.Thread(target=gathers) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    assert timer._n["gather"] == 200
    timer.reset()
    assert timer.means_ms() == {}


@pytest.mark.parametrize("gelu_impl", ["erf_poly", "erf"])
def test_scope_entries_come_in_body_order(gelu_impl):
    ds, _, _, state, step, _ = _god(gelu_impl)
    route = loop.train_route(step, state)
    before = {t.id for t in profiling.tables.values()}
    route(*ds.gather(np.arange(B)))
    (table,) = [t for t in profiling.tables.values() if t.id not in before]
    e = table.entries
    assert table.kind == "train" and table.rows is None
    assert set(e) <= set(profiling.SCOPES)
    assert e[0] == "collate"
    loss, back, adam = e.index("loss"), e.index("backward"), e.index("adam")
    assert loss < back < adam and e[adam + 1:] == ["bn_commit"]
    forward, backward = e[1:loss], e[back + 1:adam]
    # one block: two batch norms, each followed by a GELU, then the two
    # final GELUs (erf_poly's Function is a scope inside the dispatcher's)
    assert forward.count("batchnorm") == 2
    assert forward.count("gelu") == (8 if gelu_impl == "erf_poly" else 4)
    assert forward[-1] == "gelu" and forward[0] == "batchnorm"
    assert backward.count("batchnorm") == 2
    # erf_poly's backward is its own Function's; native erf's is autograd's
    assert backward.count("gelu") == (4 if gelu_impl == "erf_poly" else 0)


class _FakeNodes:
    """The driver's node reads, for a graph built by hand: ``add(letter)``
    adds a node (``None``: a node that is no operation, an event)."""

    def __init__(self, shuffle=False):
        self.nodes, self.shuffle = [], shuffle

    def add(self, letter):
        self.nodes.append((1000 + 7 * len(self.nodes), letter))

    def handles(self):
        hs = [h for h, _ in self.nodes]
        return array("Q", hs[::-1] if self.shuffle else hs).tobytes()

    def run_order(self):
        return [(h, x) for h, x in self.nodes if x is not None]


@pytest.mark.parametrize("shuffle", [False, True])
def test_capture_table_puts_nodes_down_to_the_innermost_scope(monkeypatch,
                                                              shuffle):
    fake = _FakeNodes(shuffle)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(profiling, "_GraphNodes", lambda stream: fake)
    with profiling.capture_table("train", ("fake", shuffle)) as table:
        fake.add("K")
        with profiling.scope("backward"):
            fake.add("K")
            with profiling.scope("gelu"):
                fake.add("K")
                fake.add("C")
            fake.add(None)
            fake.add("K")
        with profiling.scope("adam"):
            fake.add("S")
            fake.add("K")
        fake.add("K")
    assert profiling.scope("adam") is profiling._OFF
    assert profiling.tables[("train", ("fake", shuffle))] is table
    assert table.error is None and table.entries == ["backward", "gelu",
                                                     "adam"]
    assert table.rows == [(None, 0, 1), ("backward", 1, 1), ("gelu", 2, 2),
                          ("backward", 4, 1), ("adam", 5, 2), (None, 7, 1)]
    assert table.types == "KKKCKSKK" and table.total == 8
    assert table.counts == {None: 2, "backward": 2, "gelu": 2, "adam": 2}
    assert sum(n for _, _, n in table.rows) == table.total
