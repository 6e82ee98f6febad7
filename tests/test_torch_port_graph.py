"""The train step split into host draws and a device body
(``train/steps.py:TrainStep``) and replayed as one captured CUDA graph
(``train/graph.py:GraphedStep``), on the CPU, where ``GraphedStep`` runs
the body eagerly on its static input buffers.

* The split step (the draws from ``state.generator`` before the body) is
  bit-equal, over 3 steps, to the step it replaces (the forward drawing
  from the generator itself, and for the fused speech step the host
  gather of ``gather_speech_batch``), run eagerly and through
  ``GraphedStep``: the fused speech step, GOD's brain encoder and EEGNet
  (with its two dropout masks).
* The body makes no host read: no ``aten._local_scalar_dense``, no
  operation with a data-dependent output shape, no tensor made from host
  data (``aten.lift_fresh``), under a ``TorchDispatchMode``.
* An epoch through ``GraphedStep`` (4 updates) is bit-equal to the eager
  epoch, and agrees with JAX's ``make_gwilliams_scan_epoch`` and
  ``make_scan_epoch`` on the same draws and weights at the tolerances of
  ``tests/test_torch_port_scan_epochs.py`` (the state as
  ``tests/test_torch_port_train_slice.py`` holds it, with the 2·n·lr rule
  for gradients that are zero by construction).
* Each call returns its own metrics: no two steps share storage.
* ``fit`` replays one train ``GraphedStep`` a step on a device-resident
  set and on the same set spilled to host memory (GOD's packed set and a
  speech pool, the latter through the prefetch), with the same result,
  and on both scores every test pool through one eval ``GraphedStep``;
  the kernels' launch counters are read and credited as a replay credits
  them.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_collate_stats import stats_setup  # noqa: F401
from tests.test_torch_port_god_train import god_setup  # noqa: F401
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _collate_cfgs,
)

D1, D2, K, NB, BATCH, LR, TEMP0 = 16, 24, 4, 2, 16, 1e-3, 5.1
UPDATES, STEPS = 4, 3  # an epoch's updates; the steps of the step tests
SCHED = {"lr": LR, "epochs": 4, "lr_scheduler": "cosine"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _packed_god(s):
    from meg_decoding_tpu_torch.data.packed import PackedDataset

    arrs = [np.asarray(a) for a in (s["jds"].X, s["jds"].Y,
                                    s["jds"].subject_idxs)]
    return PackedDataset(X=torch.from_numpy(arrs[0]),
                         Y=torch.from_numpy(arrs[1]),
                         subject_idxs=torch.from_numpy(arrs[2]).long(),
                         num_subjects=2)


def _model(kind, s, ds, seed=0):
    """A small encoder of ``kind`` with dropout on, from ``seed``."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.models.eegnet import EEGNet

    gen = torch.Generator().manual_seed(seed)
    if kind == "eegnet":
        C, T = ds.X.shape[1:]
        return EEGNet(C, T, F1=4, D=2, F2=8, k1=5, k2=2, p1=2, p2=2,
                      dr1=0.5, dr2=0.5, out_dim=16, generator=gen)
    return BrainEncoder(s["loc"], 2, D1=D1, D2=D2, F=16, K=K, d_drop=0.3,
                        seq2seq=kind == "speech", num_blocks=NB,
                        generator=gen)


def _states(kind, s, ds, n):
    """``n`` identical (model, optimizer, state) triples."""
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state

    out = []
    for _ in range(n):
        model = _model(kind, s, ds)
        opt = make_optimizer(Config(SCHED), 2)
        out.append((model, opt, create_train_state(model, opt, TEMP0, seed=3)))
    return out


def _collate(kind, s):
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    return (_collate_cfgs(s["cfg"])[1] if kind == "speech"
            else CollateConfig(baseline_len_samp=5, clamp_lim=20.0))


def _steps(kind, s):
    """For ``kind``: the dataset, ``make(model, opt) → TrainStep``, the
    step's arguments for step i (after the state), and ``replaced(model,
    opt) → f(state, *args)``, the step as it ran before the split: the
    forward draws its dropout from ``state.generator`` itself, and the
    fused step gathers with ``gather_speech_batch``."""
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_train_step

    collate = _collate(kind, s)
    if kind == "speech":
        ds = s["t_tr"]

        def make(model, opt):
            return make_fused_speech_step(model, opt, LossConfig(), collate, ds)

        def args(i):
            idx = np.random.RandomState(40 + i).randint(0, len(ds), BATCH)
            return idx, torch.Generator().manual_seed(50 + i)

        def replaced(model, opt):
            body = make_train_step(model, opt, LossConfig(), collate).body

            def step(state, idx, gen):
                X, Y, subs, _ = gather_speech_batch(ds, idx, generator=gen)
                return body(state, X, Y, subs,
                            draws={"generator": state.generator})
            return step

        return ds, make, args, replaced
    ds = _packed_god(s)

    def make(model, opt):
        return make_train_step(model, opt, LossConfig(), collate)

    def args(i):
        idx = np.random.RandomState(60 + i).randint(0, len(ds), BATCH)
        return ds.gather(idx)

    def replaced(model, opt):
        body = make(model, opt).body
        return lambda state, X, Y, subs: body(
            state, X, Y, subs, draws={"generator": state.generator})

    return ds, make, args, replaced


def _assert_state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa["params"]:
        assert torch.equal(sa["params"][k], sb["params"][k]), k
    for part in ("mu", "nu"):
        for k in sa["opt"][part]:
            assert torch.equal(sa["opt"][part][k], sb["opt"][part][k]), (part, k)
    assert torch.equal(sa["opt"]["count"], sb["opt"]["count"])
    assert torch.equal(sa["step"], sb["step"])
    assert torch.equal(sa["generator"], sb["generator"])


KINDS = ["speech", "god", "eegnet"]


@pytest.mark.parametrize("kind", KINDS)
def test_split_step_equals_the_step_it_replaces(kind, stats_setup, god_setup):
    from meg_decoding_tpu_torch.train.graph import GraphedStep

    s = stats_setup if kind == "speech" else god_setup
    ds, make, args, replaced = _steps(kind, s)
    (m0, o0, s0), (m1, o1, s1), (m2, o2, s2) = _states(kind, s, ds, 3)
    old, split = replaced(m0, o0), make(m1, o1)
    graphed_step = make(m2, o2)
    graphed = GraphedStep(graphed_step.body, s2)
    for i in range(STEPS):
        want = old(s0, *args(i))
        _, got = split(s1, *args(i))
        via_graph = graphed(graphed_step.prepare(s2, *args(i)))
        assert float(want["skipped"]) == 0.0
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
            assert torch.equal(via_graph[k], want[k]), (i, k)
        _assert_state_equal(s1, s0)
        _assert_state_equal(s2, s0)
    if kind == "eegnet":
        # the masks matter: the same steps without dropout end elsewhere
        (m3, o3, s3), = _states(kind, s, ds, 1)
        m3.dr1 = m3.dr2 = 0.0
        nodrop = make(m3, o3)
        for i in range(STEPS):
            nodrop(s3, *args(i))
        assert not torch.equal(m3.conv1, m0.conv1)


class _HostReads(TorchDispatchMode):
    """Records every operation that would read the device back to the host,
    make a tensor whose shape depends on the data, or make one from host
    data."""

    FORBIDDEN = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
                 "_unique", "_unique2", "unique_consecutive", "unique_dim",
                 "lift_fresh", "lift_fresh_copy", "equal", "is_nonzero",
                 "item", "repeat_interleave")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.FORBIDDEN:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", KINDS)
def test_the_body_makes_no_host_read(kind, stats_setup, god_setup):
    s = stats_setup if kind == "speech" else god_setup
    ds, make, args, _ = _steps(kind, s)
    (model, opt, state), = _states(kind, s, ds, 1)
    step = make(model, opt)
    inputs = step.prepare(state, *args(0))
    mode = _HostReads()
    with mode:
        metrics = step.body(state, **inputs)
    assert mode.seen == []
    assert float(metrics["skipped"]) == 0.0
    # the detector sees what it looks for
    with _HostReads() as probe:
        float(metrics["loss"])
        torch.nonzero(torch.ones(3))
    assert len(probe.seen) == 2


def _jax_draws(key, n: int, n_sessions: int | None):
    """The draws of one JAX scan epoch of UPDATES updates (as
    ``tests/test_torch_port_scan_epochs.py:_jax_draws``)."""
    ikey, key = jax.random.split(key)
    idx = np.asarray(jax.random.randint(ikey, (UPDATES, BATCH), 0, n))
    if n_sessions is None:
        return idx, None
    subkeys = jax.random.split(key, UPDATES)
    return idx, np.stack([np.asarray(jax.random.randint(k, (BATCH,), 0,
                                                        n_sessions))
                          for k in subkeys])


@pytest.mark.parametrize("form", ["gwilliams-inline", "gwilliams-cached", "god"])
def test_graphed_epoch_equals_eager_epoch_and_jax(form, stats_setup, god_setup):
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_gwilliams_scan_epoch as jgw
    from meg_decoding_tpu.train.scan_loop import make_scan_epoch as jgod
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.scan_loop import (
        make_gwilliams_scan_epoch,
        make_scan_epoch,
    )
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import CollateConfig, LossConfig

    speech = form.startswith("gwilliams")
    s = stats_setup if speech else god_setup
    jm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=speech, num_blocks=NB)
    jo = jopt(JConfig(SCHED), 2)
    if speech:
        jds, ds = s["j_tr"], s["t_tr"]
        jcol, tcol = _collate_cfgs(s["cfg"])
        seg = jds.segment_table()[:4]
        example = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                          jds.speech_onsets, jds.session_subject,
                          jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                          jnp.zeros(4, jnp.int32), jds.seq_len)
        cached = form.endswith("cached")
        jepoch = jgw(jm, jo, JLoss(), jcol, jds, updates=UPDATES,
                     batch_size=BATCH, cache_collate_stats=cached)
    else:
        jds, ds = s["jds"], _packed_god(s)
        kw = dict(baseline_len_samp=5, clamp_lim=20.0)
        jcol, tcol = JCollate(**kw), CollateConfig(**kw)
        example = tuple(jnp.asarray(np.asarray(a)[:4])
                        for a in (jds.X, jds.Y, jds.subject_idxs))
        jepoch = jgod(jm, jo, JLoss(), jcol, jds, updates=UPDATES,
                      batch_size=BATCH)
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))

    runs = []
    for _ in range(2):
        tm = TEnc(s["loc"], 2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0,
                  seq2seq=speech, num_blocks=NB, device="cpu")
        tm.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith("loss.")})
        to = make_optimizer(Config(SCHED), 2)
        ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
        epoch = (make_gwilliams_scan_epoch(tm, to, LossConfig(), tcol, ds,
                                           updates=UPDATES, batch_size=BATCH,
                                           cache_collate_stats=cached)
                 if speech else
                 make_scan_epoch(tm, to, LossConfig(), tcol, ds,
                                 updates=UPDATES, batch_size=BATCH))
        runs.append((epoch, ts))
    key = jax.random.PRNGKey(33)
    idx, sess = _jax_draws(key, len(ds), ds.num_sessions if speech else None)
    given = dict(idx=idx, **({"sess_ids": sess} if speech else {}))
    (graph_epoch, gs), (eager_epoch, es) = runs
    gs, gmeans = graph_epoch(gs, **given)
    assert graph_epoch.graphed is not None and graph_epoch.graphed.state is gs
    es, emeans = eager_epoch.eager(es, **given)
    assert eager_epoch.graphed is None
    for k in emeans:
        assert torch.equal(gmeans[k], emeans[k]), k
    _assert_state_equal(gs, es)

    js, jmeans = jepoch(js, key)
    assert float(gmeans["skipped"]) == float(jmeans["skipped"]) == 0.0
    np.testing.assert_allclose(float(gmeans["loss"]), float(jmeans["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(gmeans["temp"]), float(jmeans["temp"]),
                               rtol=1e-4)
    for k in ("top1", "top10"):
        assert abs(float(gmeans[k]) - float(jmeans[k])) \
            <= 1.0 / (BATCH * UPDATES) + 1e-6, k
    assert int(gs.step) == int(js.step) == UPDATES
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**gs.model.state_dict(), "loss.temp": gs.temp.detach()}
    _assert_close_after_training(got, want, UPDATES)


def test_each_call_returns_its_own_metrics(god_setup):
    """A graph's outputs live in one buffer that every replay overwrites:
    each call's metrics are a copy, distinct from every other call's, and
    keep the values of their own step."""
    from meg_decoding_tpu_torch.train.graph import GraphedStep

    s = god_setup
    ds, make, args, _ = _steps("god", s)
    (m0, o0, s0), (m1, o1, s1) = _states("god", s, ds, 2)
    eager, step = make(m0, o0), make(m1, o1)
    graphed = GraphedStep(step.body, s1)
    want, got = [], []
    for i in range(STEPS):
        want.append(eager(s0, *args(i))[1])
        got.append(graphed(step.prepare(s1, *args(i))))
    ptrs = [m[k].data_ptr() for m in got for k in m]
    assert len(set(ptrs)) == len(ptrs)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert len({float(m["loss"]) for m in got}) == STEPS
    with pytest.raises(ValueError, match="changed from"):
        X, Y, subs = args(0)
        graphed(step.prepare(s1, X[:-1], Y[:-1], subs[:-1]))


def test_fit_replays_one_graphed_step_a_step(god_setup, monkeypatch):
    """``fit`` on a device-resident packed set runs every step through one
    train ``GraphedStep`` and every test pool through one forward
    ``GraphedStep`` of the eval step's body, each with one graph (here, on
    the CPU, their eager mode); on the same set spilled to host memory it
    does the same, one train call an update; both end in the same
    state."""
    from meg_decoding_tpu_torch.train import graph, loop
    from meg_decoding_tpu_torch.train.steps import (
        LossConfig,
        make_eval_step,
        make_train_step,
    )

    s = god_setup
    ds = _packed_god(s)
    calls = {kind: [] for kind in graph.KINDS}
    made = {kind: [] for kind in graph.KINDS}

    class Counting(graph.GraphedStep):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made[self.kind].append(self)

        def __call__(self, inputs):
            calls[self.kind].append(inputs)
            return super().__call__(inputs)

    monkeypatch.setattr(loop, "GraphedStep", Counting)
    epochs, updates, test_size = 2, 3, 8
    cfg = Config({"epochs": epochs, "batch_size": BATCH, "updates": updates,
                  "test_size": test_size})
    pools = len(loop._test_pool_starts(len(ds), test_size, True))
    assert pools > 1
    ends = {}
    for spilled in (False, True):
        for kind in graph.KINDS:
            calls[kind].clear()
            made[kind].clear()
        (model, opt, state), = _states("god", s, ds, 1)
        collate = _collate("god", s)
        step = make_train_step(model, opt, LossConfig(), collate)
        evaluate = make_eval_step(model, LossConfig(), collate)
        train = ds.to_host() if spilled else ds
        state, best = loop.fit(cfg, train, ds, state, step, evaluate, None,
                               seed=1)
        assert np.isfinite(best["train_loss"])
        assert len(made["train"]) == 1
        assert len(calls["train"]) == epochs * updates
        assert len(made["forward"]) == 1
        assert len(calls["forward"]) == epochs * pools
        # every pool has one shape: one eval graph
        assert len(made["forward"][0].programs) == 1
        assert all(len(g.programs) == 1 for g in made["train"])
        ends[spilled] = state
    _assert_state_equal(ends[False], ends[True])


def test_fit_on_a_spilled_speech_pool_replays_one_graph(stats_setup,
                                                       monkeypatch):
    """``fit`` on a speech pool spilled to host memory (host gathers
    streamed through the prefetch) makes one train ``GraphedStep`` and
    calls it once an update, as on the device-resident pool, and ends in
    the same state, bit for bit."""
    from meg_decoding_tpu_torch.cli.evaluate_speech import SpeechPool
    from meg_decoding_tpu_torch.data import prefetch
    from meg_decoding_tpu_torch.data.gwilliams import to_host
    from meg_decoding_tpu_torch.train import graph, loop
    from meg_decoding_tpu_torch.train.steps import (
        LossConfig,
        make_eval_step,
        make_train_step,
    )

    s = stats_setup
    ds = s["t_tr"]
    made, calls, streamed = [], [], []

    class Counting(graph.GraphedStep):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if self.kind == "train":
                made.append(self)

        def __call__(self, inputs):
            if self.kind == "train":
                calls.append(inputs)
            return super().__call__(inputs)

    def counted_prefetch(batches, **kw):
        streamed.append(kw)
        return prefetch.prefetch_to_device(batches, **kw)

    monkeypatch.setattr(loop, "GraphedStep", Counting)
    monkeypatch.setattr(loop, "prefetch_to_device", counted_prefetch)
    epochs, updates = 2, 3
    cfg = Config({"epochs": epochs, "batch_size": BATCH, "updates": updates,
                  "test_size": 8})
    ends = {}
    for spilled in (False, True):
        made.clear()
        calls.clear()
        streamed.clear()
        (model, opt, state), = _states("speech", s, ds, 1)
        collate = _collate("speech", s)
        train = SpeechPool(to_host(ds) if spilled else ds, seed=2)
        assert train.host_resident == spilled
        state, best = loop.fit(cfg, train, SpeechPool(ds, seed=3), state,
                               make_train_step(model, opt, LossConfig(), collate),
                               make_eval_step(model, LossConfig(), collate),
                               None, seed=1)
        assert np.isfinite(best["train_loss"]) and best["train_skipped"] == 0.0
        assert len(made) == 1 and len(made[0].programs) == 1
        assert len(calls) == epochs * updates
        assert len(streamed) == (epochs if spilled else 0)
        ends[spilled] = state
    _assert_state_equal(ends[False], ends[True])


def test_launch_counters_are_read_and_credited_together():
    """``launch_counts`` reads every counter of the kernel modules, and a
    credit adds to each (what a replay does); ``graph`` reads the same."""
    from meg_decoding_tpu_torch.ops import kernels
    from meg_decoding_tpu_torch.ops.kernels import batchnorm as bk
    from meg_decoding_tpu_torch.ops.kernels import quantile as qk
    from meg_decoding_tpu_torch.ops.kernels import window_gather as wg
    from meg_decoding_tpu_torch.train import graph

    before = kernels.launch_counts()
    assert graph.launch_counts() == before
    assert {k[:2] for k in before} == {
        (m.__name__.rsplit(".", 1)[1], attr) for m, attr in kernels._COUNTERS}
    assert ("batchnorm", "stats_route_launches", "cluster") in before
    delta = {k: i + 1 for i, k in enumerate(before)}
    kernels.add_counts(delta)
    try:
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after} == delta
        assert wg.launches == before[("window_gather", "launches", None)] + \
            delta[("window_gather", "launches", None)]
        assert qk.long_launches > 0 and bk.dx_launches > 0
    finally:
        kernels.add_counts({k: -n for k, n in delta.items()})
    assert kernels.launch_counts() == before


def test_every_kernel_module_with_counters_is_listed():
    """Each module under ``ops/kernels/`` that counts its launches (it
    defines ``reset_launches``) is in the one list, and the one reset
    zeroes every counter of the list."""
    import importlib
    import pkgutil

    from meg_decoding_tpu_torch.ops import kernels

    counting = set()
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        if hasattr(mod, "reset_launches"):
            counting.add(mod)
    listed = {m for m, _ in kernels._COUNTERS}
    assert counting == listed and len(listed) == 4
    before = kernels.launch_counts()
    kernels.add_counts(dict.fromkeys(before, 3))
    kernels.reset_launches()
    try:
        assert set(kernels.launch_counts().values()) == {0}
    finally:
        kernels.add_counts(before)
    assert kernels.launch_counts() == before
