"""The port's model zoo against the JAX package, on the CPU: ``EEGNet``,
``EEGNetSub``, ``LinearEncoder`` and ``BrainEncoderSeq2Static`` — the
forward in eval and train mode, one GOD train step per model, a few-step
EEGNet trajectory, ``get_model``'s names and warnings, ``params_from_jax``
for each model, and the GOD train and eval CLIs with each model.

Both sides build their model with their own ``get_model`` from one config
and start from the JAX init carried across by ``params_from_jax``; inputs
are made with numpy.  EEGNet runs with even kernels (k1 = 10, k2 = 4,
which XLA pads one more after than before).  flax draws dropout masks from
its own key: the forward test captures the two masks flax drew (the
dropout's output is zero exactly where a value was dropped) and hands them
to the port; the train-step test sets both masks itself, on the JAX side
through ``flax.linen.intercept_methods``.  Seq2Static runs with
``d_drop = 0`` (its spatial dropout is the speech tests').

Tolerances, each with its reason:
* forward — rtol 1e-5 with atol 1e-5·max|out| (the same f32 convolutions
  and BN sums in another order); the BN running-statistics proposals of a
  training forward rtol 1e-5, atol 1e-6;
* one train step — loss and global gradient norm rtol 1e-4, top-k exactly
  equal, the updated state as the speech trajectory test holds it
  (``tests/test_torch_port_train_slice.py``), with one more entry whose
  gradient is zero by construction: EEGNet's ``bn1.bias``.  conv2 is
  depthwise and has no bias, so the bias of feature map f adds one
  constant to each of f's output maps, which bn2 takes away again; both
  sides compute that gradient as rounding noise, which Adam turns into a
  step of up to lr, so it is held to 2·n·lr, and so is bn2's running mean,
  which carries it;
* the 6-step EEGNet trajectory — loss rtol 1e-3 at every step (one step's
  rounding carries into the next), the final state as above;
* ``params_from_jax`` — exact (a transpose).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import adam_state_from_jax, params_from_jax
from tests.test_torch_port_god_train import _cli_cfg, god_setup  # noqa: F401
from tests.test_torch_port_train_slice import LR, _assert_close_after_training

B, C, S, F, TEMP0 = 12, 8, 2, 16, 5.1
MODELS = ("eegnet", "eegnet_sub", "linear", "brain_endcoder_seq2static")
EEGNET_KW = dict(F1=4, D=2, F2=8, k1=10, k2=4, p1=2, p2=4, dr1=0.25, dr2=0.38)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _T(name):
    return 48 if name == "brain_endcoder_seq2static" else 24  # Seq2Static: T ≥ 31


def _cfg_dict(name, **kw):
    base = dict(model=name, num_subjects=S, F=F, D1=16, D2=24, K=4,
                d_drop=0.0, eegnet_sub_fixed=True, **EEGNET_KW,
                window={"start": 0.0, "end": _T(name) / 100},
                preprocs={"brain_resample_rate": 100, "last4layers": False},
                ConvBlocks={"ks": [3, 4, 3, 5, 3]})
    return {**base, **kw}


def _loc():
    return np.random.RandomState(0).rand(C, 2).astype(np.float32)


def _inputs(name, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, C, _T(name)).astype(np.float32)
    Y = rng.randn(B, F).astype(np.float32)
    subs = np.arange(B) % S
    return X, Y, subs


def _models(name, **kw):
    """(flax module, its variables as numpy, the port's module loaded with
    them) from one config."""
    from meg_decoding_tpu.models.factory import get_model as jget
    from meg_decoding_tpu_torch.models.factory import get_model

    d = _cfg_dict(name, **kw)
    jm = jget(JConfig(d), loc=_loc(), num_channels=C)
    X, _, subs = _inputs(name)
    variables = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(subs))))
    tm = get_model(Config(d), _loc(), device="cpu", seed=0, num_channels=C)
    tm.load_state_dict({k: v for k, v in params_from_jax(variables).items()
                        if not k.startswith("loss.")})
    return jm, variables, tm


def _assert_out_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _is_dropout(context):
    return isinstance(context.module, nn.Dropout) and context.method_name == "__call__"


def _nhwc_to_nchw(m):
    return np.ascontiguousarray(np.transpose(np.asarray(m), (0, 3, 1, 2)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name, train):
    from meg_decoding_tpu_torch.models.layers import FusedBatchNorm

    jm, variables, tm = _models(name)
    X, _, subs = _inputs(name, seed=3)
    jX, jsubs = jnp.asarray(X), jnp.asarray(subs)
    tX, tsubs = torch.from_numpy(X), torch.from_numpy(subs)
    if not train:
        tm.eval()
        want = jm.apply(variables, jX, jsubs)
        with torch.no_grad():
            _assert_out_close(tm(tX, tsubs).numpy(), want)
        return

    masks = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if _is_dropout(context):
            masks.append(np.asarray(out) != 0)
        return out

    rngs = {"dropout": jax.random.PRNGKey(7), "spatial": jax.random.PRNGKey(8)}
    with nn.intercept_methods(capture):
        if "batch_stats" in variables:
            want, upd = jm.apply(variables, jX, jsubs, train=True, rngs=rngs,
                                 mutable=["batch_stats"])
        else:
            want, upd = jm.apply(variables, jX, jsubs, train=True, rngs=rngs), {}
    tm.train()
    kw = {}
    if name.startswith("eegnet"):
        assert len(masks) == 2 and all(0.3 < m.mean() < 0.95 for m in masks)
        kw["dropout_masks"] = tuple(torch.from_numpy(_nhwc_to_nchw(m))
                                    for m in masks)
    elif name == "brain_endcoder_seq2static":
        kw["centre"] = 0  # d_drop = 0 drops no channel
    with torch.no_grad():
        _assert_out_close(tm(tX, tsubs, **kw).numpy(), want)
    want_stats = params_from_jax({"params": {},
                                  "batch_stats": jax.tree_util.tree_map(
                                      np.asarray, upd.get("batch_stats", {}))})
    bns = {n: m for n, m in tm.named_modules() if isinstance(m, FusedBatchNorm)}
    assert len(want_stats) == 2 * len(bns)
    for n, m in bns.items():
        for k, v in zip(("mean", "var"), m.proposed):
            np.testing.assert_allclose(v.numpy(), want_stats[f"{n}.{k}"].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{n}.{k}")


def test_eegnet_without_masks_draws_them_from_the_generator():
    """A training forward draws its two masks from the caller's generator:
    the same generator state gives the same output, another state another
    one, and dropout never runs in eval mode."""
    _, _, tm = _models("eegnet")
    X, _, subs = _inputs("eegnet", seed=4)
    tX, tsubs = torch.from_numpy(X), torch.from_numpy(subs)
    tm.train()
    with torch.no_grad():
        a = tm(tX, tsubs, generator=torch.Generator().manual_seed(1))
        b = tm(tX, tsubs, generator=torch.Generator().manual_seed(1))
        c = tm(tX, tsubs, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="masks or a torch.Generator"):
            tm(tX, tsubs)
        tm.eval()
        d = tm(tX, tsubs, generator=torch.Generator().manual_seed(1))
        e = tm(tX, tsubs, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e)


# --- train steps ------------------------------------------------------------

def _collates():
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    kw = dict(baseline_len_samp=4, clamp_lim=20.0)
    return JCollate(**kw), CollateConfig(**kw)


def _pair(name, sched, **kw):
    """The JAX train step and state, and the port's from the same init."""
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_train_step as jmake
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_train_step

    jm, variables, tm = _models(name, **kw)
    jcol, tcol = _collates()
    X, Y, subs = _inputs(name)
    jo = jopt(JConfig(sched), 2)
    js = jstate(jm, jo, (jnp.asarray(X), jnp.asarray(Y), jnp.asarray(subs)),
                jax.random.PRNGKey(1), init_temperature=TEMP0)
    # the JAX state's own init, carried across
    tm.load_state_dict({k: v for k, v in params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats})).items()
        if not k.startswith("loss.")})
    jstep = jmake(jm, jo, JLoss(grad_norms=True), jcol)
    to = make_optimizer(Config(sched), 2)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tstep = make_train_step(tm, to, LossConfig(grad_norms=True), tcol)
    return jstep, js, tstep, ts


def _assert_state_close(js, ts, steps: int):
    """The port's state against JAX's after ``steps`` updates (module
    docstring)."""
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    if "conv2" in want:  # EEGNet's noise-only entries
        for k in ("bn1.bias", "bn2.mean"):
            np.testing.assert_allclose(got.pop(k).numpy(), want.pop(k).numpy(),
                                       rtol=0, atol=2.0 * steps * LR, err_msg=k)
    _assert_close_after_training(got, want, steps)


def _masks(name, seed):
    """Two dropout masks in the port's NCHW layout (keep 0.75 and 0.62)."""
    T1 = _T(name) // EEGNET_KW["p1"]
    rng = np.random.RandomState(seed)
    return (rng.rand(B, EEGNET_KW["D"] * EEGNET_KW["F1"], 1, T1) < 0.75,
            rng.rand(B, EEGNET_KW["F2"], 1, T1 // EEGNET_KW["p2"]) < 0.62)


def _set_masks(jstep_call, tm, masks):
    """Run ``jstep_call`` with flax's two dropouts replaced by ``masks``
    (NCHW), and make the port's model take the same masks."""
    order = {}

    def inject(next_fun, args, kwargs, context):
        if not _is_dropout(context):
            return next_fun(*args, **kwargs)
        i = order.setdefault(context.module.name, len(order))
        x = args[0]
        keep = 1.0 - context.module.rate
        m = jnp.asarray(np.transpose(masks[i], (0, 2, 3, 1)))
        return jnp.where(m, x / keep, jnp.zeros_like(x))

    with nn.intercept_methods(inject):
        out = jstep_call()
    assert len(order) == 2
    forward = tm.forward
    # the step hands the masks it drew to the forward: these replace them
    tm.forward = lambda *a, **k: forward(*a, **{**k, "dropout_masks": tuple(
        torch.from_numpy(np.ascontiguousarray(m)) for m in masks)})
    return out


@pytest.mark.parametrize("name", MODELS)
def test_god_train_step_matches_jax(name):
    sched = {"lr": LR, "epochs": 3, "lr_scheduler": "none"}
    jstep, js, tstep, ts = _pair(name, sched)
    X, Y, subs = _inputs(name, seed=5)
    jargs = (jnp.asarray(X), jnp.asarray(Y), jnp.asarray(subs))
    if name.startswith("eegnet"):
        js, jmet = _set_masks(lambda: jstep(js, *jargs), ts.model,
                              _masks(name, 6))
    else:
        js, jmet = jstep(js, *jargs)
    ts, met = tstep(ts, torch.from_numpy(X), torch.from_numpy(Y),
                    torch.from_numpy(subs), centre=0)
    assert float(met["skipped"]) == float(jmet["skipped"]) == 0.0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("top1", "top10"):
        assert round(float(met[k]) * B) == round(float(jmet[k]) * B), k
    _assert_state_close(js, ts, 1)


def test_eegnet_trajectory_matches_jax():
    """6 steps of EEGNet with dropout off and a cosine schedule (2 updates
    an epoch, so the learning rate changes every second step)."""
    sched = {"lr": LR, "epochs": 4, "lr_scheduler": "cosine"}
    jstep, js, tstep, ts = _pair("eegnet", sched, **{"dr1": 0.0, "dr2": 0.0})
    steps = 6
    for i in range(steps):
        X, Y, subs = _inputs("eegnet", seed=20 + i)
        js, jmet = jstep(js, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(subs))
        ts, met = tstep(ts, torch.from_numpy(X), torch.from_numpy(Y),
                        torch.from_numpy(subs))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
    assert int(ts.step) == int(js.step) == steps
    _assert_state_close(js, ts, steps)


# --- factory and interop -----------------------------------------------------

def _both(name, **kw):
    """Both factories on one config with ``kw`` over ``_cfg_dict``'s keys:
    (JAX class name, port class name, JAX warnings, port warnings, port
    model)."""
    from meg_decoding_tpu.models.factory import get_model as jget
    from meg_decoding_tpu_torch.models.factory import get_model

    d = _cfg_dict(name, **kw)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        j = jget(JConfig(d), loc=_loc(), num_channels=C)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        t = get_model(Config(d), _loc(), device="cpu", num_channels=C)
    return type(j).__name__, type(t).__name__, len(jw), len(tw), t


def test_get_model_names_and_lever_warnings():
    from meg_decoding_tpu_torch.models.factory import get_model

    for name, kw, cls in (
            ("eegnet", {}, "EEGNet"),
            ("eegnet_sub", {}, "EEGNetSub"),
            ("eegnet_sub", {"eegnet_sub_fixed": False}, "EEGNet"),
            ("linear", {}, "LinearEncoder"),
            ("brain_endcoder_seq2static", {}, "BrainEncoderSeq2Static"),
            ("brain_encoder", {}, "BrainEncoder")):
        jn, tn, jwarn, twarn, _ = _both(name, **kw)
        assert jn == tn == cls, (name, kw)
        assert jwarn == twarn == 0
    # the classifier's input: F2 · ((T // p1) // p2), T from the window
    model = _both("eegnet")[-1]
    assert model.classifier.weight.shape == (F, 8 * ((24 // 2) // 4))
    # levers only the brain_encoder family has warn elsewhere, on both sides
    for lever in ({"gelu_approximate": True}, {"emit_bf16_z": True},
                  {"gelu_impl": "tanh"}):
        for name in ("eegnet", "linear"):
            assert _both(name, **lever)[2:4] == (1, 1), (name, lever)
        assert _both("brain_endcoder_seq2static", **lever)[2:4] == (0, 0)
    with pytest.raises(ValueError, match="no model named"):
        get_model(Config(_cfg_dict("eegnet2")), _loc(), device="cpu",
                  num_channels=C)
    with pytest.raises(ValueError, match="num_channels"):
        get_model(Config(_cfg_dict("linear")), _loc(), device="cpu")


@pytest.mark.parametrize("name", MODELS)
def test_params_from_jax_round_trip(name):
    """Every flax leaf lands in one port entry, in the port's layout, and
    the module gives the converted entries back unchanged; Adam's moments
    take the parameters' names."""
    import optax

    jm, variables, tm = _models(name)
    sd = params_from_jax(variables)
    got = tm.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    p = variables["params"]
    if name.startswith("eegnet"):
        # HWIO (C, 1, 1, D·F1) → OIHW (D·F1, 1, C, 1)
        np.testing.assert_array_equal(
            sd["conv2"].numpy()[:, 0, :, 0], p["conv2"]["kernel"][:, 0, 0, :].T)
        np.testing.assert_array_equal(
            sd["conv3_pw"].numpy()[:, :, 0, 0], p["conv3_pw"]["kernel"][0, 0].T)
    if name == "eegnet_sub":
        bank = p["conv1_sub"]  # (S, 1, k1, 1, F1)
        np.testing.assert_array_equal(sd["conv1_sub"].numpy()[:, :, 0, 0, :],
                                      np.transpose(bank[:, 0, :, 0, :], (0, 2, 1)))
    adam = adam_state_from_jax(jax.tree_util.tree_map(
        np.asarray, optax.adam(1e-3).init(p)))
    assert set(adam.mu) == set(adam.nu) == {n for n, _ in tm.named_parameters()}


# --- the GOD CLIs -------------------------------------------------------------

@pytest.mark.parametrize("model,extra", [
    ("eegnet", {}),
    ("eegnet_sub", {"eegnet_sub_fixed": True}),
    ("eegnet_sub", {}),
    ("linear", {}),
    ("brain_endcoder_seq2static", {"window": {"start": 0.0, "end": 0.4}}),
], ids=["eegnet", "eegnet_sub_fixed", "eegnet_sub", "linear", "seq2static"])
def test_god_clis_train_and_evaluate_the_zoo(god_setup, tmp_path, model,
                                             extra):
    """One cv epoch through the train CLI, then the eval CLI on its
    checkpoint.  Seq2Static takes a 0.4 s window (T = 40 at 100 Hz); the
    pools need T ≥ 31."""
    from meg_decoding_tpu_torch.cli import evaluate_god, train_god
    from meg_decoding_tpu_torch.models.factory import get_model

    cfg = _cli_cfg(god_setup, tmp_path, epochs=1, model=model,
                   **EEGNET_KW, **extra)
    best = train_god.run(cfg, device="cpu")
    assert best["train_skipped"] == 0.0
    assert np.isfinite(best["train_loss"]) and np.isfinite(best["test_loss"])
    built = get_model(Config(to_dict(cfg)), god_setup["loc"], device="cpu",
                      num_channels=8)
    want = {"eegnet_sub": "EEGNetSub" if extra else "EEGNet",
            "eegnet": "EEGNet", "linear": "LinearEncoder",
            "brain_endcoder_seq2static": "BrainEncoderSeq2Static"}[model]
    assert type(built).__name__ == want
    res = evaluate_god.run(Config(to_dict(cfg)), device="cpu")
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())
    assert os.path.exists(os.path.join(cfg.save_root, "ckpt", "model_best.pt"))
