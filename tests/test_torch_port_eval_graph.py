"""The port's forward-only programs as captured CUDA graphs
(``train/graph.py:GraphedStep`` of kind ``forward``), on the CPU, where a
``GraphedStep`` runs its body eagerly on its static input buffers and
returns copies of its outputs: the eval step's body (``train/steps.py:
EvalStep``, JAX's ``jax.jit(eval_step)``), the serving forward
(``serving/export.py:make_serving_forward``, JAX's ``jax.jit(fwd)``), a
loaded artifact (``ServingModel``, one graph per batch size as JAX's
``Exported.call``), both eval CLIs and ``fit``'s test pools.

JAX runs on the CPU, its Pallas kernels in interpret mode as
``tests/test_pallas.py`` runs them; weights cross through
``interop.params_from_jax``.

Tolerances, each with its reason:
* the graphed eval step against JAX's — the speech seq2seq encoder with its
  inline collate: Z rtol/atol 1e-4, as ``tests/test_torch_port_slice.py``
  holds the eager step (the collate's divisions and the convolutions
  round in another order, amplified by the scaling); GOD's encoder (the
  classification and MSE kinds): Z within 1e-5·max|Z|, as
  ``tests/test_torch_port_god_train.py`` holds ``predict``; the loss rtol
  1e-4, the temperature exactly, top-k hit counts exactly;
* the graphed serving forward against JAX's jitted forward — rtol/atol
  1e-4 (as the slice test); the graphed artifact against JAX's artifact —
  rtol/atol 1e-5 (as ``tests/test_torch_port_serving_export.py``);
* every graph route against its eager body, and ``fit`` with both graphs
  against ``fit`` with both routes eager — bit for bit: the same
  operations on the same inputs.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_god_train import (  # noqa: F401
    _batch,
    _cli_cfg,
    _collates,
    god_setup,
)
from tests.test_torch_port_graph import (
    _HostReads,
    _assert_state_equal,
    _collate,
    _packed_god,
    _states,
    _steps,
)
from tests.test_torch_port_serving_export import artifacts  # noqa: F401
from tests.test_torch_port_slice import (  # noqa: F401
    _collate_cfgs,
    _pools,
    slice_setup,
)

D1, D2, K, NB, F, TEMP = 16, 24, 4, 2, 16, 5.1
SPEECH_RTOL = 1e-4
GOD_RTOL = 1e-5
ARTIFACT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Counting:
    """Records the ``GraphedStep``s a module makes and their calls."""

    def __init__(self, monkeypatch, module):
        from meg_decoding_tpu_torch.train import graph

        self.made, self.calls = [], []
        outer = self

        class Counting(graph.GraphedStep):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                outer.made.append(self)

            def __call__(self, inputs):
                outer.calls.append(self)
                return super().__call__(inputs)

        monkeypatch.setattr(module, "GraphedStep", Counting)


def _forward_graph(body, model):
    from meg_decoding_tpu_torch.train.graph import GraphedStep

    return GraphedStep(body, device="cpu",
                       reads=[*model.parameters(), *model.buffers()])


def _assert_same_pytree(got, want):
    got_l, got_s = torch.utils._pytree.tree_flatten(got)
    want_l, want_s = torch.utils._pytree.tree_flatten(want)
    assert got_s == want_s
    for g, w in zip(got_l, want_l):
        assert torch.equal(g, w)


# --- the eval step -------------------------------------------------------------

def _god_pair(s, loss_kind):
    """JAX's GOD encoder and state, and the port's encoder with its
    weights; JAX's eval step and the port's, for ``loss_kind``."""
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.objectives.retrieval import cosine_similarity_matrix as jcos
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_eval_step as jmake
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.objectives.retrieval import cosine_similarity_matrix
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_eval_step

    jcol, tcol = _collates(s["cfg"])
    kw = dict(kind=loss_kind, label_offset=1 if loss_kind == "classification"
              else 0)
    jm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=F, K=K,
              d_drop=0.0, seq2seq=False, num_blocks=NB)
    jb, _ = _batch(s["jds"], np.arange(4))
    js = jstate(jm, jopt(JConfig({"lr": 1e-3, "epochs": 4,
                                  "lr_scheduler": "none"}), 4), jb,
                jax.random.PRNGKey(2), init_temperature=TEMP)
    jg = jnp.asarray(s["gallery"])
    jstep = jmake(jm, JLoss(**kw), jcol, gallery=jg,
                  gallery_self_sim=jcos(jg, jg))
    tm = TEnc(s["loc"], 2, D1=D1, D2=D2, F=F, K=K, d_drop=0.0, seq2seq=False,
              num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    tg = torch.from_numpy(s["gallery"])
    tstep = make_eval_step(tm, LossConfig(**kw), tcol, gallery=tg,
                           gallery_self_sim=cosine_similarity_matrix(tg, tg))
    return jstep, js, tstep, tm


@pytest.mark.parametrize("kind", ["clip", "classification", "mse"])
def test_graphed_eval_step_matches_jax(kind, slice_setup, god_setup):
    """Each loss kind's eval step through one forward ``GraphedStep`` of
    its body, pool after pool of one shape: against JAX's eval step, and
    bit for bit against the eager step; the body makes no host read."""
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_eval_step as jmake
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_eval_step

    pools = []
    if kind == "clip":
        s = slice_setup
        jcol, tcol = _collate_cfgs(s["cfg"])
        jstep = jmake(s["jm"], JLoss(), jcol)
        tstep = make_eval_step(s["tm"], LossConfig(), tcol)
        tm, rtol = s["tm"], SPEECH_RTOL
        params = {"model": s["variables"]["params"],
                  "loss": {"temp": jnp.asarray(TEMP)}}
        batch_stats = s["variables"]["batch_stats"]
        jds, ds = s["j_te"], s["t_te"]
        for seg_ids, sess in _pools(len(ds), 16, seed=3):
            seg = jds.segment_table()[seg_ids]
            j = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                        jds.speech_onsets, jds.session_subject,
                        jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                        jnp.asarray(sess), jds.seq_len)
            t = gather_speech_batch(ds, seg_ids, sess_ids=sess)[:3]
            pools.append((j, t, None, None))
    else:
        s = god_setup
        jstep, js, tstep, tm = _god_pair(s, kind)
        params, batch_stats, rtol = js.params, js.batch_stats, GOD_RTOL
        n = len(np.asarray(s["jds"].X))
        for start in (0, 16, n - 16):
            (jX, jY, js_, jl), (tX, tY, ts_, tl) = _batch(
                s["jds"], np.arange(start, start + 16))
            pools.append(((jX, jY, js_), (tX, tY, ts_), jl, tl))
    graphed = _forward_graph(tstep.body, tm)
    for i, (j, t, jl, tl) in enumerate(pools):
        jmet, JZ = jstep(params, batch_stats, *j, jl)
        inputs = tstep.prepare(*t, TEMP, tl)
        with _HostReads() as probe:
            met, Z = graphed(inputs)
        assert probe.seen == [], probe.seen
        _assert_same_pytree((met, Z), tstep(*t, TEMP, tl))
        JZ = np.asarray(JZ)
        np.testing.assert_allclose(Z.numpy(), JZ, rtol=rtol,
                                   atol=rtol * np.abs(JZ).max())
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        assert float(met["temp"]) == float(jmet["temp"])
        B = Z.shape[0]
        for k in ("top1", "top10"):
            assert round(float(met[k]) * B) == round(float(jmet[k]) * B), (i, k)
    assert len(pools) > 1 and len(graphed.programs) == 1


# --- the serving forward and the artifact ---------------------------------------

def test_graphed_serving_forward_matches_jax(slice_setup):
    """The serving forward at two batch sizes (two graphs of one forward),
    against JAX's jitted forward and bit for bit against its eager body."""
    from meg_decoding_tpu.serving.export import make_serving_forward as jmake
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.serving import export

    s = slice_setup
    jcol, tcol = _collate_cfgs(s["cfg"])
    jfwd = jax.jit(jmake(s["jm"], jcol))
    made = []
    forward = export.make_serving_forward(tcol)
    rng = np.random.RandomState(4)
    for B in (8, 5, 8):
        X, _, subs, _ = gather_speech_batch(
            s["t_tr"], rng.randint(0, len(s["t_tr"]), B),
            generator=torch.Generator().manual_seed(B))
        want = np.asarray(jfwd(s["variables"], jnp.asarray(X.numpy()),
                               jnp.asarray(subs.numpy())))
        got = forward(s["tm"], X, subs)
        assert got.shape == (B, F, s["t_tr"].seq_len)
        np.testing.assert_allclose(got.numpy(), want, rtol=SPEECH_RTOL,
                                   atol=SPEECH_RTOL)
        assert torch.equal(got, forward.body(s["tm"], X, subs))
        made.append(got)
    # the model's graphs: one per batch size
    assert list(forward.graphs) == [s["tm"]]
    assert len(forward.graphs[s["tm"]].programs) == 2
    assert made[0].data_ptr() != made[2].data_ptr()


def test_graphed_artifact_serves_each_batch_size_and_each_weight_change(artifacts):
    """A loaded artifact at two batch sizes (two graphs) against JAX's
    artifact; a weight set to 1.5 times itself changes Z, setting the old
    tensor back gives the first Z bit for bit, and so does an in-place
    write and its undoing."""
    from meg_decoding_tpu_torch.serving.export import load_artifact

    served = load_artifact(artifacts["tdir"], device="cpu")
    rng = np.random.RandomState(21)
    first = {}
    for B in (3, 6, 3):
        X = (2.0 * rng.randn(B, 12, 40) + 0.3).astype(np.float32)
        subs = rng.randint(0, 3, B).astype(np.int32)
        got = served(X, subs)
        want = np.asarray(artifacts["jax"](X, subs))
        np.testing.assert_allclose(got.numpy(), want, rtol=ARTIFACT_RTOL,
                                   atol=ARTIFACT_RTOL)
        assert torch.equal(got, served.body(X, subs))
        first.setdefault(B, (X, subs, got))
    assert len(served.graphed.programs) == 2

    X, subs, z0 = first[3]
    key = "conv_final2.weight"
    w = served.weights[key]
    served.weights[key] = w * 1.5
    scaled = served(X, subs)
    assert not torch.allclose(scaled, z0)
    served.weights[key] = w
    assert served.weights[key] is w
    assert torch.equal(served(X, subs), z0)
    # a write in place reaches the next request, and so does its undoing
    with torch.no_grad():
        w.mul_(2.0)
    doubled = served(X, subs)
    assert not torch.allclose(doubled, z0)
    with torch.no_grad():
        w.div_(2.0)
    assert torch.equal(served(X, subs), z0)
    # a whole new dict too
    served.weights = {k: v * 1.5 if k == key else v
                      for k, v in served.weights.items()}
    assert torch.equal(served(X, subs), scaled)


def test_each_call_returns_its_own_outputs(slice_setup, artifacts):
    """A graph's outputs live in buffers that every replay overwrites: each
    call of the serving forward, the eval step's graph and the artifact
    returns copies, distinct from every other call's, that keep their own
    values after later calls."""
    from meg_decoding_tpu_torch.serving.export import (
        load_artifact,
        make_serving_forward,
    )
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_eval_step

    s = slice_setup
    _, tcol = _collate_cfgs(s["cfg"])
    forward = make_serving_forward(tcol)
    step = make_eval_step(s["tm"], LossConfig(), tcol)
    graphed = _forward_graph(step.body, s["tm"])
    served = load_artifact(artifacts["tdir"], device="cpu")
    rng = np.random.RandomState(8)
    L = s["t_tr"].seq_len
    outs, wants = [], []
    for i in range(3):
        X = torch.from_numpy(rng.randn(4, 12, L).astype(np.float32))
        Y = torch.from_numpy(rng.randn(4, F, L).astype(np.float32))
        subs = torch.from_numpy(rng.randint(0, 3, 4))
        Xa = rng.randn(4, 12, 40).astype(np.float32)
        outs.append((forward(s["tm"], X, subs),
                     graphed(step.prepare(X, Y, subs, TEMP)),
                     served(Xa, subs.numpy().astype(np.int32))))
        wants.append((forward.body(s["tm"], X, subs), step(X, Y, subs, TEMP),
                      served(Xa, subs.numpy().astype(np.int32)).clone()))
    leaves = [t for o in outs for t in torch.utils._pytree.tree_flatten(o)[0]]
    ptrs = [t.data_ptr() for t in leaves]
    assert len(set(ptrs)) == len(ptrs)
    for o, w in zip(outs, wants):
        _assert_same_pytree(o, w)
    assert len({float(o[1][0]["loss"]) for o in outs}) == 3


# --- host reads and signatures ---------------------------------------------------

ZOO = ("brain_encoder-seq2seq", "brain_encoder", "brain_endcoder_seq2static",
       "eegnet", "eegnet_sub", "linear")


@pytest.mark.parametrize("name", ZOO)
def test_eval_body_makes_no_host_read(name):
    """The eval step's body of every model of the zoo reads nothing back to
    the host, makes no tensor whose shape depends on the data and none
    from host data: what a captured graph cannot hold."""
    from meg_decoding_tpu_torch.models.factory import get_model
    from meg_decoding_tpu_torch.train.steps import (
        CollateConfig,
        LossConfig,
        make_eval_step,
    )

    model_name, _, head = name.partition("-")
    T = 48 if model_name == "brain_endcoder_seq2static" else 24
    C, S, B = 8, 2, 6
    cfg = Config(dict(model=model_name, num_subjects=S, F=F, D1=D1, D2=D2,
                      K=K, d_drop=0.0, eegnet_sub_fixed=True,
                      seq2seq=head == "seq2seq", F1=4, D=2, F2=8, k1=10, k2=4,
                      p1=2, p2=4, window={"start": 0.0, "end": T / 100},
                      preprocs={"brain_resample_rate": 100,
                                "last4layers": False},
                      ConvBlocks={"ks": [3, 4, 3, 5, 3]}))
    loc = np.random.RandomState(0).rand(C, 2).astype(np.float32)
    model = get_model(cfg, loc, device="cpu", seed=0, num_channels=C)
    step = make_eval_step(model, LossConfig(),
                          CollateConfig(baseline_len_samp=5, clamp_lim=20.0))
    rng = np.random.RandomState(1)
    X = torch.from_numpy(rng.randn(B, C, T).astype(np.float32))
    with torch.no_grad():
        Z_shape = tuple(model.eval()(X, torch.zeros(B, dtype=torch.long)).shape)
    Y = torch.from_numpy(rng.randn(*Z_shape).astype(np.float32))
    subs = torch.from_numpy(np.arange(B) % S)
    inputs = step.prepare(X, Y, subs, torch.tensor(TEMP))
    with _HostReads() as probe:
        metrics, Z = step.body(**inputs)
    assert probe.seen == [], probe.seen
    assert tuple(Z.shape) == Z_shape and bool(torch.isfinite(metrics["loss"]))


def test_a_new_signature_makes_a_new_forward_graph_and_raises_for_a_train_body(
        god_setup):
    """A forward captures one graph per input signature (shapes, dtypes)
    and reuses it; a train step keeps its one signature and raises for
    another."""
    from meg_decoding_tpu_torch.serving.export import make_serving_forward
    from meg_decoding_tpu_torch.train.graph import GraphedStep

    s = god_setup
    ds, make, args, _ = _steps("god", s)
    (model, opt, state), = _states("god", s, ds, 1)
    forward = make_serving_forward(_collate("god", s))
    graphed = GraphedStep(lambda X, subject_idxs: forward.body(model, X,
                                                                subject_idxs),
                          device="cpu", reads=list(model.parameters()))
    X, _, subs = args(0)[:3]
    shapes = [(X[:8], subs[:8]), (X[:5], subs[:5]), (X[:8], subs[:8].int()),
              (X[8:], subs[8:])]
    for x, sub in shapes:
        got = graphed({"X": x, "subject_idxs": sub})
        assert torch.equal(got, forward.body(model, x, sub))
    assert len(graphed.programs) == 3  # B = 8 twice in int64, once in int32
    assert graphed.kind == "forward"

    step = make(model, opt)
    train = GraphedStep(step.body, state)
    train(step.prepare(state, *args(0)))
    with pytest.raises(ValueError, match="changed from"):
        train(step.prepare(state, X[:-1], *args(0)[1:]))
    assert len(train.programs) == 1 and train.kind == "train"


# --- the eval CLIs and fit --------------------------------------------------------

def _eager_forward(make_serving_forward):
    """A ``make_serving_forward`` whose forward is its eager body."""
    return lambda collate_cfg=None: make_serving_forward(collate_cfg).body


@pytest.mark.parametrize("cli", ["speech", "god"])
def test_eval_clis_on_the_graph_route_equal_the_eager_body(
        cli, slice_setup, god_setup, tmp_path, monkeypatch):
    """Both eval CLIs on the CPU: their results through one graph of the
    forward equal their results through its eager body, every pool or
    batch of one shape replaying that one graph; GOD's ``predict`` with an
    overlapped last batch too."""
    from meg_decoding_tpu_torch.cli import evaluate_god, evaluate_speech
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.models.factory import get_model
    from meg_decoding_tpu_torch.serving import export

    if cli == "speech":
        s = slice_setup
        cfg = Config(dict(to_dict(s["cfg"]), model="brain_encoder", D1=D1,
                          D2=D2, K=K, F=F, seq2seq=True, batch_size=16,
                          num_subjects=3, save_root=str(tmp_path / "out")))
        model = get_model(cfg, ch_locations_2d(cfg), device="cpu", seed=7)
        module, run = evaluate_speech, evaluate_speech.run
    else:
        cfg = _cli_cfg(god_setup, tmp_path, epochs=1)
        _, val, model = evaluate_god._build(Config(to_dict(cfg)),
                                            torch.device("cpu"))
        module, run = evaluate_god, evaluate_god.run
    ckpt = tmp_path / "out" / "ckpt"
    ckpt.mkdir(parents=True)
    torch.save(dict(model.state_dict(), **{"loss.temp": torch.tensor(TEMP)}),
               ckpt / "model.pt")

    counting = _Counting(monkeypatch, export)
    graph_res = run(Config(to_dict(cfg)), device="cpu")
    (graphed,) = counting.made
    assert len(graphed.programs) == 1
    if cli == "speech":
        assert len(counting.calls) == graph_res["n_pools"] > 1
    else:
        assert len(counting.calls) == 1
        Z = evaluate_god.predict(cfg, model, val, batch_size=7)
        assert len(counting.made[-1].programs) == 1
        assert len(counting.calls) == 1 + 3  # 20 epochs: 0, 7, 13
    monkeypatch.setattr(module, "make_serving_forward",
                        _eager_forward(export.make_serving_forward))
    eager_res = run(Config(to_dict(cfg)), device="cpu")
    assert graph_res == eager_res
    if cli == "god":
        assert torch.equal(Z, evaluate_god.predict(cfg, model, val,
                                                   batch_size=7))


class _Eager:
    """A stand-in for ``GraphedStep`` that runs the body eagerly on the
    inputs as given: ``fit`` with both routes eager."""

    def __init__(self, body, state=None, device="cuda", reads=(), mesh=None):
        self.body, self.state = body, state

    def __call__(self, inputs):
        if self.state is None:
            return self.body(**inputs)
        return self.body(self.state, **inputs)


def test_fit_with_both_graphs_equals_fit_with_both_eager(god_setup, tmp_path,
                                                         monkeypatch):
    """``fit`` replaying the train graph and the eval graph ends bit for
    bit where ``fit`` with both routes eager ends, with the same test
    metrics every epoch: each epoch's pools read that epoch's weights."""
    from meg_decoding_tpu_torch.train import loop
    from meg_decoding_tpu_torch.train.steps import (
        LossConfig,
        make_eval_step,
        make_train_step,
    )
    from meg_decoding_tpu_torch.utils.logging import RunLogger

    s = god_setup
    ds = _packed_god(s)
    cfg = Config({"epochs": 3, "batch_size": 16, "updates": 2,
                  "test_size": 8})
    ends, rows = {}, {}
    for route in ("graph", "eager"):
        if route == "eager":
            monkeypatch.setattr(loop, "GraphedStep", _Eager)
        (model, opt, state), = _states("god", s, ds, 1)
        collate = _collate("god", s)
        logger = RunLogger(str(tmp_path / route), run_name="fit")
        state, _ = loop.fit(cfg, ds, ds, state,
                            make_train_step(model, opt, LossConfig(), collate),
                            make_eval_step(model, LossConfig(), collate),
                            logger, seed=2)
        with open(logger.path) as f:
            rows[route] = [{k: v for k, v in json.loads(line).items()
                            if k.startswith(("train_", "test_"))}
                           for line in f]
        ends[route] = state
    _assert_state_equal(ends["graph"], ends["eager"])
    assert rows["graph"] == rows["eager"]
    assert len(rows["graph"]) == 3
    assert len({r["test_loss"] for r in rows["graph"]}) == 3


def test_serving_benchmark_rows_eager_and_graph_on_the_cpu(monkeypatch):
    """``cli/serving_benchmark.py`` on the CPU (a narrow encoder in place
    of the full-width one): an ``eager`` and a ``graph`` row a batch size,
    their device numbers null, as a CPU run measures no device."""
    from meg_decoding_tpu_torch.cli import serving_benchmark as sb
    from meg_decoding_tpu_torch.data.layout import (
        normalize_locations,
        synthetic_cap_locations,
    )
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    def narrow(device, seq2seq, seed=0):
        loc = normalize_locations(synthetic_cap_locations(sb.C))
        return BrainEncoder(loc, sb.NUM_SUBJECTS, D1=D1, D2=D2, F=F, K=K,
                            seq2seq=seq2seq, num_blocks=NB, device=device)

    monkeypatch.setattr(sb, "C", 12)
    monkeypatch.setattr(sb, "T", 90)
    monkeypatch.setattr(sb, "full_width_encoder", narrow)
    rows = sb.main(["--device", "cpu", "--batches", "1,3", "--iters", "2",
                    "--seq2seq"])
    assert [(r["source"], r["batch"]) for r in rows] == [
        ("eager", 1), ("graph", 1), ("eager", 3), ("graph", 3)]
    for r in rows:
        assert r["device"] == "cpu" and r["p50_ms"] > 0 and r["first_ms"] > 0
        assert r["device_ops_per_request"] is None
        assert r["busy_ms_per_request"] is None and r["idle_share"] is None
