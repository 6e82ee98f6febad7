"""The port's serving artifact (``serving/export.py``), its export CLI
(``cli/export_model.py``) and the custom op it calls, against the JAX
package on the CPU.

* The artifact: one set of weights (a flax init carried into the port by
  ``interop.params_from_jax``) exported by both packages, loaded by both,
  served at B = 1, 4 and 7 on finite sensor data: rtol/atol 1e-5 (the
  convolutions and the collate's divisions round in another order; the
  percentiles agree within 1 ulp, ``tests/test_torch_port_kernels.py``).
  The ±inf inputs where the JAX package's two percentile backends differ
  are Queue 3's, with their own test there.
* The weights are call-time arguments: the program holds no parameter or
  buffer of the model, and scaling a loaded weight by 1.5 changes Z.
* ``meta.json`` has JAX's keys, ``platforms`` ``["cuda", "cpu"]`` and the
  custom op.
* ``torch.library.opcheck`` on ``meg_decoding_tpu_torch::robust_quantiles``
  (its schema, fake kernel and dispatch), and the op inside the program.
* The export CLI: a speech and a GOD checkpoint trained by the port's train
  CLI, written also as a JAX train state (the same weights), exported by
  both CLIs; the two artifacts serve the same Z (rtol/atol 1e-5), and the
  port's equals the port's eager forward bit for bit on the CPU.
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

C, T, F, S, D1, D2, K, NB = 12, 40, 16, 3, 8, 12, 4, 2
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A seq2seq brain encoder exported by both packages with one set of
    weights and one collate."""
    from meg_decoding_tpu.data.layout import (
        normalize_locations,
        synthetic_cap_locations,
    )
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.serving import export as jexport
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.serving import export
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    loc = np.asarray(normalize_locations(synthetic_cap_locations(C)))
    jm = JEnc(loc=loc, num_subjects=S, D1=D1, D2=D2, F=F, K=K, seq2seq=True,
              num_blocks=NB)
    rng = np.random.RandomState(0)
    variables = jax.device_get(jm.init(
        {"params": jax.random.PRNGKey(0), "spatial": jax.random.PRNGKey(1)},
        jnp.asarray(rng.randn(2, C, T), jnp.float32), jnp.zeros(2, jnp.int32)))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*np.shape(a)).astype(np.float32),
        variables["batch_stats"])
    root = tmp_path_factory.mktemp("artifacts")
    jdir = jexport.save_artifact(str(root / "jax"), jm,
                                 {"model": variables["params"]},
                                 variables["batch_stats"], C, T,
                                 JCollate(baseline_len_samp=5, clamp_lim=20.0))
    model = BrainEncoder(loc, S, D1=D1, D2=D2, F=F, K=K, seq2seq=True,
                         num_blocks=NB, device="cpu")
    model.load_state_dict(params_from_jax(variables))
    collate = CollateConfig(baseline_len_samp=5, clamp_lim=20.0)
    tdir = export.save_artifact(str(root / "port"), model, C, T, collate)
    return dict(jax=jexport.load_artifact(jdir), jdir=jdir, tdir=tdir,
                port=export.load_artifact(tdir, device="cpu"), model=model,
                collate=collate)


@pytest.mark.parametrize("B", [1, 4, 7])
def test_artifact_matches_jax_artifact(artifacts, B):
    from meg_decoding_tpu_torch.serving.export import make_serving_forward

    rng = np.random.RandomState(10 + B)
    X = (3.0 * rng.randn(B, C, T) + 0.5).astype(np.float32)
    subs = rng.randint(0, S, B).astype(np.int32)
    got = artifacts["port"](X, subs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, F, T)
    want = np.asarray(artifacts["jax"](X, subs))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the same program as the eager serving forward of the port
    eager = make_serving_forward(artifacts["collate"])(
        artifacts["model"], torch.from_numpy(X), torch.from_numpy(subs))
    assert torch.equal(got, eager)
    # numpy in, tensors in: the same result
    assert torch.equal(artifacts["port"](torch.from_numpy(X),
                                         torch.from_numpy(subs).long()), got)


def test_weights_are_call_time_arguments(artifacts):
    from meg_decoding_tpu_torch.serving.export import load_artifact

    served = load_artifact(artifacts["tdir"], device="cpu")
    program = served.program
    assert program.state_dict == {} and program.example_inputs is None
    kinds = {s.kind.name for s in program.graph_signature.input_specs}
    assert kinds <= {"USER_INPUT", "CONSTANT_TENSOR"}
    # the constants are the non-persistent buffers (the Fourier basis)
    model = artifacts["model"]
    persistent = set(model.state_dict())
    basis = sum(b.numel() for k, b in model.named_buffers() if k not in persistent)
    assert sum(c.numel() for c in program.constants.values()) <= basis
    weight_names = set(torch.load(os.path.join(artifacts["tdir"], "weights.pt"),
                                  weights_only=True))
    assert weight_names == set(artifacts["model"].state_dict())
    rng = np.random.RandomState(2)
    X = rng.randn(2, C, T).astype(np.float32)
    subs = np.zeros(2, np.int32)
    z0 = served(X, subs)
    served.weights["conv_final2.weight"] = served.weights["conv_final2.weight"] * 1.5
    z1 = served(X, subs)
    assert not torch.allclose(z0, z1)


def test_meta_has_jax_keys_and_the_custom_op(artifacts):
    with open(os.path.join(artifacts["tdir"], "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(artifacts["jdir"], "meta.json")) as f:
        jmeta = json.load(f)
    assert set(jmeta) <= set(meta)
    assert set(meta) - set(jmeta) == {"custom_ops"}
    assert meta["input"] == jmeta["input"] == {
        "X": [None, C, T], "X_dtype": "float32", "subject_idxs": [None],
        "subject_idxs_dtype": "int32"}
    assert meta["collate"] == jmeta["collate"]
    assert meta["platforms"] == ["cuda", "cpu"]
    assert meta["custom_ops"] == ["meg_decoding_tpu_torch::robust_quantiles"]
    assert meta["model"] == jmeta["model"] == "BrainEncoder"
    assert artifacts["port"].platforms == ("cuda", "cpu")


def test_the_program_calls_the_custom_op_once(artifacts):
    ops = [n.target for n in artifacts["port"].program.graph.nodes
           if n.op == "call_function"]
    assert ops.count(torch.ops.meg_decoding_tpu_torch.robust_quantiles.default) == 1
    assert not any("sort" in str(op) for op in ops)
    # no dtype assertion and no cast to the dtype a tensor has is left
    assert torch.ops.aten._assert_tensor_metadata.default not in ops
    for n in artifacts["port"].program.graph.nodes:
        if n.target is torch.ops.aten.to.dtype and "output" not in {
                u.op for u in n.users}:
            assert n.args[0].meta["val"].dtype != n.args[1]


@pytest.mark.parametrize("shape,qs", [((10, 37), [25.0, 50.0, 75.0]),
                                      ((3, 1500), [50.0]),
                                      ((4, 1), [25.0, 50.0, 75.0, 90.0])])
def test_opcheck_robust_quantiles(shape, qs):
    from meg_decoding_tpu_torch.ops.kernels import quantile as qk

    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    torch.library.opcheck(qk.OP, (x, qs))
    got = torch.ops.meg_decoding_tpu_torch.robust_quantiles(x, qs)
    assert torch.equal(got, qk.robust_quantiles_plain(x, tuple(qs)))


def test_collate_through_the_op_equals_the_direct_route(monkeypatch):
    """The eager collate reaches its percentiles through the registered op,
    once, and gives what the plain version called directly gives."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from meg_decoding_tpu_torch.ops import scaling
    from meg_decoding_tpu_torch.ops.kernels import quantile as qk

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    X = torch.from_numpy(np.random.RandomState(3).randn(5, C, T).astype(np.float32))
    with Ops():
        got = scaling.collate_preprocess(X, 5, 20.0)
    assert seen.count(torch.ops.meg_decoding_tpu_torch.robust_quantiles.default) == 1
    monkeypatch.setattr(scaling, "robust_quantiles", qk.robust_quantiles_plain)
    assert torch.equal(got, scaling.collate_preprocess(X, 5, 20.0))


def test_served_weights_are_checked_against_the_program(artifacts):
    from meg_decoding_tpu_torch.serving import export

    served = export.load_artifact(artifacts["tdir"], device="cpu")
    w = served.weights["conv_final2.weight"]
    with pytest.raises(ValueError, match="conv_final2.weight"):
        served.weights["conv_final2.weight"] = w.double()
    with pytest.raises(ValueError, match="conv_final2.weight"):
        served.weights["conv_final2.weight"] = w[:1]
    with pytest.raises(KeyError, match="no weight"):
        served.weights["conv_final3.weight"] = w
    with pytest.raises(ValueError, match="program's names"):
        served.weights = {k: v for k, v in served.weights.items()
                          if k != "conv_final2.weight"}
    with pytest.raises(ValueError, match="conv_final2.weight"):
        served.weights = dict(served.weights, **{"conv_final2.weight": w.half()})
    assert served.weights["conv_final2.weight"] is w


# --- the export CLI -----------------------------------------------------------

def _jax_state_with(jstate, sd: dict):
    """The JAX train state ``jstate`` holding the port's state_dict ``sd``
    (the inverse of ``params_from_jax``'s renames and layouts)."""
    def from_port(prefix, tree):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = from_port(key + ".", v)
                continue
            if k == "kernel":
                w = sd[key[: -len("kernel")] + "weight"].numpy()
                w = w.T if w.ndim == 2 else np.transpose(w, (2, 1, 0))
            else:
                w = sd[key].numpy()
            assert w.shape == np.shape(v), key
            out[k] = jnp.asarray(w)
        return out

    params = jax.device_get(jstate.params)
    new_params = {"model": from_port("", params["model"]),
                  "loss": {"temp": jnp.asarray(sd["loss.temp"].numpy())}}
    return jstate.replace(params=new_params,
                          batch_stats=from_port("", jax.device_get(jstate.batch_stats)))


def _export_both(cfg: Config, jstate_of, which: str):
    """The port's checkpoint ``which`` written as a JAX train state beside
    it, then both export CLIs: returns (port artifact, JAX artifact)."""
    from meg_decoding_tpu.cli.export_model import run as jexport_run
    from meg_decoding_tpu.serving.export import load_artifact as jload
    from meg_decoding_tpu.train.checkpoint import CheckpointManager as JCkpt
    from meg_decoding_tpu_torch.cli.export_model import run as export_run
    from meg_decoding_tpu_torch.serving.export import load_artifact

    ckpt_dir = os.path.join(cfg.save_root, "ckpt")
    sd = torch.load(os.path.join(ckpt_dir, f"{which}.pt"),
                    weights_only=True)["params"]
    jstate = _jax_state_with(jstate_of(JConfig(to_dict(cfg))), sd)
    JCkpt(os.path.join(cfg.save_root, "jax_ckpt")).save(which, jstate)
    out = export_run(Config(dict(to_dict(cfg), export_dir=os.path.join(
        cfg.save_root, "export"))), device="cpu")
    jout = jexport_run(JConfig(dict(to_dict(cfg), export_dir=os.path.join(
        cfg.save_root, "jax_export"), ckpt_dir=os.path.join(
            cfg.save_root, "jax_ckpt"))))
    return load_artifact(out, device="cpu"), jload(jout)


def test_export_cli_speech_checkpoint_matches_jax_export(tmp_path):
    from meg_decoding_tpu.cli.train_speech import _load_gwilliams
    from meg_decoding_tpu.models.factory import get_model as jget_model
    from meg_decoding_tpu.data.layout import ch_locations_2d as jloc
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jcreate
    from meg_decoding_tpu_torch.cli.train_speech import run as train_run
    from meg_decoding_tpu_torch.data.synthetic import (
        make_synthetic_gwilliams_cache,
    )

    cache = str(tmp_path / "cache")
    base = make_synthetic_gwilliams_cache(cache, n_subjects=2, n_sessions_per=1,
                                          C=C, rate=40, rec_sec=30.0,
                                          words_per_task=16, F=F, seed=1)
    cfg = Config(dict(to_dict(base), model="brain_encoder", D1=D1, D2=D2, K=K,
                      F=F, seq2seq=True, batch_size=8, updates=2, epochs=1,
                      lr=1e-3, cache_dir=cache, save_root=str(tmp_path / "out"),
                      run_name="r"))
    train_run(cfg, device="cpu")

    def jstate_of(jcfg):
        train_set, _ = _load_gwilliams(jcfg, 0)
        jcfg.num_subjects = train_set.num_subjects
        model = jget_model(jcfg, loc=jloc(jcfg))
        X = jnp.zeros((2, C, 12), jnp.float32)
        return jcreate(model, jopt(jcfg, 2), (X, None, jnp.zeros(2, jnp.int32)),
                       jax.random.PRNGKey(0))

    served, jserved = _export_both(cfg, jstate_of, "model_best")
    assert served.meta["dataset"] == jserved.meta["dataset"] == "Gwilliams2022"
    assert served.meta["checkpoint"] == "model_best"
    assert served.meta["collate"] == jserved.meta["collate"]
    assert served.meta["collate"]["enabled"] is True
    assert served.meta["input"] == jserved.meta["input"]
    nC, seq = served.meta["input"]["X"][1:]
    rng = np.random.RandomState(3)
    X = rng.randn(3, nC, seq).astype(np.float32)
    subs = np.array([0, 1, 0], np.int32)
    Z = served(X, subs)
    assert tuple(Z.shape) == (3, F, seq)
    np.testing.assert_allclose(Z.numpy(), np.asarray(jserved(X, subs)),
                               rtol=RTOL, atol=ATOL)


def test_export_cli_god_checkpoint_matches_jax_export(tmp_path):
    from meg_decoding_tpu.cli import evaluate_god as jeval
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jcreate
    from meg_decoding_tpu_torch.cli import evaluate_god
    from meg_decoding_tpu_torch.cli.evaluate_speech import load_model_state
    from meg_decoding_tpu_torch.cli.train_god import run as train_run
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    root = str(tmp_path / "god")
    base = make_synthetic_god_dataset(root, subjects=("sbj01", "sbj02"),
                                      n_train=20, n_test=10, feat_dim=F)
    cfg = Config(dict(to_dict(base), model="brain_encoder", D1=D1, D2=D2, K=K,
                      F=F, seq2seq=False, batch_size=8, updates=2, epochs=1,
                      use_sampler=True, lr=1e-3, lr_scheduler="none",
                      training_mode="split", test_size=8,
                      save_root=os.path.join(root, "out"), run_name="r",
                      image_features_path=None))
    train_run(cfg, device="cpu")

    def jstate_of(jcfg):
        source, _, model = jeval._build(jcfg)
        return jcreate(model, jopt(jcfg, 2), source.gather(np.arange(8)),
                       jax.random.PRNGKey(0))

    served, jserved = _export_both(cfg, jstate_of, "model_best")
    assert served.meta["dataset"] == "GOD" and served.meta["collate"]["enabled"]
    _, val, model = evaluate_god._build(Config(to_dict(cfg)), torch.device("cpu"))
    X, _, subs = val.gather(np.arange(8))[:3]
    Z = served(X, subs)
    np.testing.assert_allclose(
        Z.numpy(), np.asarray(jserved(X.numpy(), subs.numpy().astype(np.int32))),
        rtol=RTOL, atol=ATOL)
    # the evaluator's predict on the same checkpoint
    model.load_state_dict(load_model_state(
        os.path.join(cfg.save_root, "ckpt", "model_best.pt"), "cpu"))
    ref = evaluate_god.predict(cfg, model, val.subset(np.arange(8)), batch_size=8)
    assert torch.equal(Z, ref)
