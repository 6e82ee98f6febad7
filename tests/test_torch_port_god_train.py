"""The port's GOD training and evaluation path against the JAX package, on
the CPU: every loss and criterion (values and gradients), the GOD metrics,
one train step per loss kind, a GOD trajectory, ``predict`` and the eval
CLI's metrics from the same weights, and the train / eval CLIs end to end.

Both sides take the same batches (made with numpy from the JAX-built
dataset) and start from one init converted with ``params_from_jax``; the
encoders run with ``d_drop = 0`` (the dropout centre is the speech tests'
subject, ``tests/test_torch_port_train_slice.py``).

Tolerances, each with its reason:
* the loss functions and metrics on the same f32 inputs — values rtol
  1e-5, gradients rtol 1e-4 / atol 1e-6 (f32 sums in another order);
  top-k and pairwise hits exactly equal;
* one train step — loss and global gradient norm rtol 1e-4 (the encoder's
  convolutions and BN sums accumulate in another order), the updated
  state as the speech trajectory test holds it (rtol 1e-4 / atol 1e-5, and
  2·n·lr for the entries whose gradient is zero by construction);
* the 8-step trajectory — loss rtol 1e-3 at every step (one step's
  rounding carries into the next), the final state as above;
* ``predict`` — max |ΔZ| ≤ 1e-5·max|Z| (the same forward in another order);
* the eval CLIs' retrieval, zero-shot and pairwise metrics, both run end to
  end on one Z handed to both — within 1e-6 (the same hit counts; the
  fractions are f32 on one side, f64 on the other).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_train_slice import _assert_close_after_training

D1, D2, K, NB, BATCH, LR, TEMP0 = 16, 24, 4, 2, 16, 1e-3, 5.1
N_TRAIN, F = 40, 16
assert LR == 1e-3  # the walk of _assert_close_after_training


@pytest.fixture(scope="module")
def god_setup(tmp_path_factory):
    """Two subjects × (40 train, 10 val) trials, 8 ROI channels, T = 20 at
    100 Hz, rest z-scoring and both normalizations; the train split built
    by both packages, and a 48-image training gallery."""
    from meg_decoding_tpu.data.god import build_god_dataset as jbuild
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    root = str(tmp_path_factory.mktemp("god_train"))
    cfg = make_synthetic_god_dataset(root, subjects=("sbj01", "sbj02"),
                                     n_train=N_TRAIN, n_test=10, feat_dim=F)
    cfg = Config(dict(to_dict(cfg), z_scoring=True, normalize_meg=True,
                      normalize_image_features=True))
    jds = jbuild(JConfig(to_dict(cfg)), "train")
    rng = np.random.RandomState(5)
    gallery_train = os.path.join(root, "image_features_train.npy")
    np.save(gallery_train, rng.randn(48, F).astype(np.float32))
    gallery_test = os.path.join(root, "image_features.npy")
    np.save(gallery_test, rng.randn(10, F).astype(np.float32))
    return dict(cfg=cfg, root=root, jds=jds, loc=ch_locations_2d(cfg),
                gallery=np.load(gallery_train), gallery_train=gallery_train,
                gallery_test=gallery_test)


def _batch(jds, idx):
    """The same batch for both sides: (jax arrays, torch tensors)."""
    arrs = [np.asarray(a)[idx] for a in (jds.X, jds.Y, jds.subject_idxs,
                                         jds.labels)]
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    t[2], t[3] = t[2].long(), t[3].long()
    return j, t


# --- loss functions and metrics ----------------------------------------------

def _grads_jax(fn, *args):
    return jax.value_and_grad(fn, argnums=tuple(range(len(args))))(*args)


def _grads_torch(fn, *args):
    ts = [torch.tensor(np.asarray(a), requires_grad=True) for a in args]
    v = fn(*ts)
    return v, torch.autograd.grad(v, ts)


def _assert_value_and_grads(tv, tg, jv, jg):
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("criterion", ["crossentropy", "binary_crossentropy",
                                       "similarity_crossentropy"])
@pytest.mark.parametrize("train", [True, False])
def test_classification_loss_matches_jax(criterion, train):
    from meg_decoding_tpu.objectives import losses as jl
    from meg_decoding_tpu.objectives.retrieval import cosine_similarity_matrix as jcos
    from meg_decoding_tpu_torch.objectives import losses as tl
    from meg_decoding_tpu_torch.objectives.retrieval import cosine_similarity_matrix

    rng = np.random.RandomState(11)
    x = rng.randn(12, 3, 4).astype(np.float32)
    gallery = rng.randn(40, 12).astype(np.float32)
    labels = rng.randint(0, 40, 12)
    temp = np.float32(1.7)
    jself = jcos(jnp.asarray(gallery), jnp.asarray(gallery))
    tself = cosine_similarity_matrix(torch.from_numpy(gallery),
                                     torch.from_numpy(gallery))
    np.testing.assert_allclose(tself.numpy(), np.asarray(jself), rtol=1e-5,
                               atol=1e-6)
    jv, jg = _grads_jax(lambda a, t: jl.clip_like_classification_loss(
        a, jnp.asarray(labels), jnp.asarray(gallery), t, criterion=criterion,
        train=train, gallery_self_similarity=jself), jnp.asarray(x), temp)
    tv, tg = _grads_torch(lambda a, t: tl.clip_like_classification_loss(
        a, torch.from_numpy(labels), torch.from_numpy(gallery), t,
        criterion=criterion, train=train, gallery_self_similarity=tself), x, temp)
    _assert_value_and_grads(tv, tg, jv, jg)


def test_mse_same_label_and_targets_match_jax():
    from meg_decoding_tpu.objectives import losses as jl
    from meg_decoding_tpu_torch.objectives import losses as tl

    rng = np.random.RandomState(12)
    Y = rng.randn(10, 6).astype(np.float32)
    Z = rng.randn(10, 6).astype(np.float32)
    jv, jg = _grads_jax(jl.mse_loss, jnp.asarray(Y), jnp.asarray(Z))
    tv, tg = _grads_torch(tl.mse_loss, Y, Z)
    _assert_value_and_grads(tv, tg, jv, jg)
    Zs = rng.randn(10, 3, 4).astype(np.float32)  # seq2seq rows flatten
    for labels in (np.array([1, 2, 1, 3, 2, 1, 4, 5, 6, 7]), np.arange(10)):
        jv, jg = _grads_jax(lambda z: jl.same_label_loss(z, jnp.asarray(labels)),
                            jnp.asarray(Zs))
        tv, tg = _grads_torch(lambda z: tl.same_label_loss(
            z, torch.from_numpy(labels)), Zs)
        _assert_value_and_grads(tv, tg, jv, jg)
    assert float(tv.detach()) == 0.0  # no two labels equal
    labels = np.array([0, 7, 8, 15, 16, 39])
    got = tl.smooth_category_targets(torch.from_numpy(labels), 40, 8, 0.25)
    want = jl.smooth_category_targets(jnp.asarray(labels), 40, 8, 0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 0] == 0.25 and got[1, 8] == 0.0 and got[1, 7] == 1.0  # 7 // 8


def test_god_metrics_match_jax():
    from meg_decoding_tpu.objectives import retrieval as jr
    from meg_decoding_tpu_torch.objectives import retrieval as tr

    rng = np.random.RandomState(13)
    Z = rng.randn(30, 8).astype(np.float32)
    gallery = rng.randn(12, 8).astype(np.float32)
    labels = rng.randint(0, 12, 30)
    Z[:12] += 2 * gallery[labels[:12]]  # some hits
    got = tr.zero_shot_classification(torch.from_numpy(Z), torch.from_numpy(gallery),
                                      torch.from_numpy(labels), top_ks=(1, 3, 10))
    want = jr.zero_shot_classification(jnp.asarray(Z), jnp.asarray(gallery),
                                       jnp.asarray(labels), top_ks=(1, 3, 10))
    assert got.keys() == want.keys()
    for k in want:
        assert round(float(got[k]) * 30) == round(float(want[k]) * 30), k
    assert 0 < float(got["top1"]) < 1
    for metric in ("correlation", "cosine"):
        got = tr.pairwise_identification_gallery(
            torch.from_numpy(Z), torch.from_numpy(gallery),
            torch.from_numpy(labels), metric=metric)
        want = jr.pairwise_identification_gallery(
            jnp.asarray(Z), jnp.asarray(gallery), jnp.asarray(labels),
            metric=metric)
        np.testing.assert_array_equal(got.numpy() * 11, np.asarray(want) * 11)
    with pytest.raises(ValueError):
        tr.pairwise_identification_gallery(torch.from_numpy(Z),
                                           torch.from_numpy(gallery),
                                           torch.from_numpy(labels), metric="l2")


# --- train steps ------------------------------------------------------------

def _collates(cfg):
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    kw = dict(baseline_len_samp=int(100 * cfg.preprocs.baseline_len_sec),
              clamp_lim=float(cfg.preprocs.clamp_lim))
    return JCollate(**kw), CollateConfig(**kw)


def _pair(s, loss_kw, sched=None):
    """The JAX train step with its initial state, and the port's with a
    train state converted from it."""
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.objectives.retrieval import cosine_similarity_matrix as jcos
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_train_step as jmake
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.objectives.retrieval import cosine_similarity_matrix
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_train_step

    sched = sched or {"lr": LR, "epochs": 4, "lr_scheduler": "none"}
    jcol, tcol = _collates(s["cfg"])
    jm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=F, K=K, d_drop=0.0,
              seq2seq=False, num_blocks=NB)
    jb, _ = _batch(s["jds"], np.arange(4))
    jo = jopt(JConfig(sched), 4)
    js = jstate(jm, jo, jb, jax.random.PRNGKey(0), init_temperature=TEMP0)
    jg = jnp.asarray(s["gallery"])
    jstep = jmake(jm, jo, JLoss(grad_norms=True, **loss_kw), jcol, gallery=jg,
                  gallery_self_sim=jcos(jg, jg))

    tm = TEnc(s["loc"], 2, D1=D1, D2=D2, F=F, K=K, d_drop=0.0, seq2seq=False,
              num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    with torch.no_grad():
        tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    to = make_optimizer(Config(sched), 4)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tg = torch.from_numpy(s["gallery"])
    tstep = make_train_step(tm, to, LossConfig(grad_norms=True, **loss_kw), tcol,
                            gallery=tg,
                            gallery_self_sim=cosine_similarity_matrix(tg, tg))
    return jstep, js, tstep, ts


def _state_dicts(js, ts):
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    return got, want


def _same_label_batch(jds):
    """8 epochs of subject 0 and the 8 of subject 1 that show the same
    images: every label twice."""
    labels = np.asarray(jds.labels)
    first = np.arange(8)
    twins = [N_TRAIN + int(np.flatnonzero(labels[N_TRAIN:] == labels[i])[0])
             for i in first]
    return np.concatenate([first, twins])


@pytest.mark.parametrize("name,loss_kw", [
    ("clip", {}),
    ("clip_same_label", dict(same_label_weight=0.5)),
    ("mse_l2", dict(kind="mse", l2_weight=1e-3)),
    ("classification_ce", dict(kind="classification", label_offset=1)),
    ("classification_bce", dict(kind="classification", label_offset=1,
                                criterion="binary_crossentropy")),
    ("classification_sim", dict(kind="classification", label_offset=1,
                                criterion="similarity_crossentropy")),
])
def test_god_train_step_per_loss_kind_matches_jax(god_setup, name, loss_kw):
    s = god_setup
    jstep, js, tstep, ts = _pair(s, loss_kw)
    (jX, jY, jsubs, jlab), (tX, tY, tsubs, tlab) = _batch(
        s["jds"], _same_label_batch(s["jds"]))
    js, jmet = jstep(js, jX, jY, jsubs, jlab)
    ts, met = tstep(ts, tX, tY, tsubs, tlab)
    assert float(met["skipped"]) == float(jmet["skipped"]) == 0.0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("top1", "top10"):
        assert round(float(met[k]) * BATCH) == round(float(jmet[k]) * BATCH), k
    got, want = _state_dicts(js, ts)
    _assert_close_after_training(got, want, 1)


def test_god_trajectory_matches_jax(god_setup):
    """8 steps of the CLIP loss with a cosine schedule (4 updates an epoch,
    so the learning rate changes every fourth step) over random batches."""
    s = god_setup
    sched = {"lr": LR, "epochs": 3, "lr_scheduler": "cosine"}
    jstep, js, tstep, ts = _pair(s, {}, sched)
    rng = np.random.RandomState(21)
    steps = 8
    for i in range(steps):
        (jX, jY, jsubs, _), (tX, tY, tsubs, _) = _batch(
            s["jds"], rng.randint(0, 2 * N_TRAIN, BATCH))
        js, jmet = jstep(js, jX, jY, jsubs)
        ts, met = tstep(ts, tX, tY, tsubs)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
    assert int(ts.step) == int(js.step) == steps
    got, want = _state_dicts(js, ts)
    _assert_close_after_training(got, want, steps)


# --- CLIs -------------------------------------------------------------------

def _cli_cfg(s, tmp_path, **kw):
    d = dict(to_dict(s["cfg"]), model="brain_encoder", D1=D1, D2=D2, K=K, F=F,
             seq2seq=False, batch_size=BATCH, lr=LR, lr_scheduler="none",
             updates=1200, test_size=50, use_sampler=False,
             init_temperature=TEMP0, seed=0, training_mode="cv",
             save_root=str(tmp_path / "out"),
             image_features_path=s["gallery_test"])
    return Config({**d, **kw})


def _rows(save_root):
    import json

    rows = []
    runs = os.path.join(save_root, "runs")
    for run in sorted(os.listdir(runs)):
        with open(os.path.join(runs, run, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    return rows


EVAL_KEYS = {"val_top1", "val_top10", "zeroshot_top1", "zeroshot_top10",
             "pairwise_correlation", "pairwise_cosine"}


def test_train_god_and_evaluate_god_end_to_end(god_setup, tmp_path):
    """cv split (33 of 40 epochs a subject train, 7 test: 4 updates an
    epoch), checkpoints and resume, then the eval CLI through ``main`` on
    the run's dumped config."""
    from meg_decoding_tpu_torch.cli import evaluate_god, train_god
    from meg_decoding_tpu_torch.models.factory import get_model
    from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state

    s = god_setup
    cfg = _cli_cfg(s, tmp_path, epochs=2, run_name="first")
    best = train_god.run(cfg, device="cpu")
    rows = _rows(cfg.save_root)
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all(r["train_skipped"] == 0.0 and np.isfinite(r["train_loss"])
               and np.isfinite(r["test_loss"]) for r in rows)
    assert best["epoch"] in (0, 1)
    model = get_model(cfg, s["loc"], device="cpu", seed=9)
    fresh = create_train_state(model, make_optimizer(cfg, 4), seed=9)
    ckpt = CheckpointManager(os.path.join(cfg.save_root, "ckpt"))
    assert int(ckpt.restore("model_last", fresh).step) == 8
    assert ckpt.exists("model_best")

    cfg2 = _cli_cfg(s, tmp_path, epochs=3, resume=True, run_name="second")
    train_god.run(cfg2, device="cpu")
    assert [r["epoch"] for r in _rows(cfg.save_root)] == [0, 1, 2]
    assert int(ckpt.restore("model_last", fresh).step) == 12

    run_dir = os.path.join(cfg.save_root, "runs", "second")
    res = evaluate_god.main(["--config-path", run_dir, "--config-name",
                             "config", "--device", "cpu"])
    assert set(res) == EVAL_KEYS
    assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in res.values())
    assert os.path.exists(os.path.join(cfg.save_root, "eval_results.json"))


def test_train_god_classification_on_the_split_sessions(god_setup, tmp_path):
    """``training_mode: split`` (the val sessions as the test set, normalized
    with the train statistics) with the gallery classification loss."""
    from meg_decoding_tpu_torch.cli import train_god

    s = god_setup
    cfg = _cli_cfg(s, tmp_path, epochs=1, training_mode="split",
                   criterion="similarity_crossentropy",
                   image_features_train_path=s["gallery_train"],
                   loss={"kind": "classification"})
    best = train_god.run(cfg, device="cpu")
    assert best["train_skipped"] == 0.0 and np.isfinite(best["test_loss"])
    assert 0.0 <= best["test_top1"] <= best["test_top10"] <= 1.0


def test_god_clis_refuse_unported_paths(god_setup, tmp_path):
    from meg_decoding_tpu_torch.cli import evaluate_god, train_god

    # host_resident and use_wandb are ported (tests/test_torch_port_spill.py)
    # data parallelism is ported (tests/test_torch_port_data_parallel.py);
    # a distributed: block without its rendezvous keys is refused
    with pytest.raises(ValueError, match="coordinator_address"):
        train_god.run(_cli_cfg(god_setup, tmp_path, epochs=1, distributed=True),
                      device="cpu")
    # error_analysis is ported (tests/test_torch_port_eval_analysis.py);
    # the eval CLI refuses a checkpoint that is not there
    with pytest.raises(FileNotFoundError):
        evaluate_god.run(_cli_cfg(god_setup, tmp_path, error_analysis=True,
                                  save_root=str(tmp_path / "nothing")),
                         device="cpu")


def test_predict_and_eval_metrics_match_jax(god_setup, tmp_path, monkeypatch):
    """One set of weights saved for both packages (an orbax train state for
    the JAX eval CLI, a state_dict for the port's): ``predict`` on the val
    split, then both eval CLIs end to end."""
    from meg_decoding_tpu.cli import evaluate_god as jeval
    from meg_decoding_tpu.train.checkpoint import CheckpointManager as JCkpt
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu_torch.cli import evaluate_god

    s = god_setup
    cfg = _cli_cfg(s, tmp_path, epochs=1)
    jcfg = JConfig(to_dict(cfg))
    jsource, jval, jmodel = jeval._build(jcfg)
    example = jsource.gather(np.arange(8))
    jst = jstate(jmodel, jopt(jcfg, 1200), example, jax.random.PRNGKey(3))
    ckpt_dir = os.path.join(cfg.save_root, "ckpt")
    JCkpt(ckpt_dir).save("model_best", jst)
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jst.params, "batch_stats": jst.batch_stats}))
    torch.save(sd, os.path.join(ckpt_dir, "model_best.pt"))

    _, val, model = evaluate_god._build(Config(to_dict(cfg)), torch.device("cpu"))
    model.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    Z = evaluate_god.predict(cfg, model, val, batch_size=7)  # overlapped tail
    jZ = jeval.predict(jcfg, jmodel, jst, jval, batch_size=7)
    assert Z.shape == jZ.shape == (20, F)
    _close = np.abs(Z.numpy() - jZ).max() / np.abs(jZ).max()
    assert _close <= 1e-5, _close

    # an encoder at its init maps every epoch to nearly one Z (spread
    # ~1e-7), where rounding reorders the rankings; the CLIs' metrics are
    # held on one informative Z handed to both (Y of the epoch + noise)
    rng = np.random.RandomState(4)
    Zfix = (np.asarray(jval.Y) + 1.5 * rng.randn(*jZ.shape)).astype(np.float32)
    monkeypatch.setattr(jeval, "predict", lambda *a, **k: Zfix)
    monkeypatch.setattr(evaluate_god, "predict",
                        lambda *a, **k: torch.from_numpy(Zfix))
    got = evaluate_god.run(Config(to_dict(cfg)), device="cpu")
    want = jeval.run(JConfig(to_dict(cfg)))
    assert set(got) == set(want) == EVAL_KEYS
    assert 0.0 < got["val_top1"] < 1.0 and 0.5 < got["pairwise_cosine"] < 1.0
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
