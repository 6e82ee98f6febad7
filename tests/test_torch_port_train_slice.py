"""The port's training slice against the JAX package, end to end on the CPU:
a synthetic Gwilliams cache → packed dataset → the fused step (session draw,
window gather, collate, encoder in training mode, CLIP loss, gradients,
Adam, BN running statistics, top-k) from one converted init, and ``fit``
through the port's train CLI.

Both sides take the same segment ids; the sessions are those the JAX fused
step draws (``jax.random.randint(key, (B,), 0, n_sessions)``), handed to
the port.  flax's ``make_rng`` derives the dropout key in a way the port
cannot reproduce, so the 12-step trajectory runs with ``d_drop = 0`` and a
one-step test with dropout on fixes the centre on both sides.

Tolerances, each with its reason:
* loss at every step — rtol 1e-3: the convolutions, BN sums and the CLIP
  logits accumulate in another order, and the small differences of one
  step's update carry into the next;
* top-1 / top-10 at step 1 — exactly equal (the same hits of one batch);
* parameters and BN running statistics after n steps — rtol 1e-4,
  atol 1e-5, except where the gradient is zero by construction: the bias
  of a convolution that feeds a BatchNorm (the BN takes the channel mean
  away again), the running mean of that BN (it carries the bias), and the
  (0, 0) Fourier column of ``z_re`` (it shifts every channel's softmax
  logit alike).  Both sides compute those gradients as rounding noise of
  ~1e-9, and Adam divides each gradient by its own running RMS, so the
  noise becomes steps of up to about lr in directions the two sides do
  not share.  Those entries are held to atol 2·n·lr, two such steps per
  update.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax

D1, D2, K, NB, BATCH, STEPS, LR = 16, 24, 4, 2, 16, 12, 1e-3
TEMP0 = 5.1


@pytest.fixture(scope="module")
def train_setup(tmp_path_factory):
    """A small cache (C=12, F=16, 40 Hz → T=120) and both packed training
    splits."""
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache

    cache = str(tmp_path_factory.mktemp("gw_train") / "cache")
    cfg = make_synthetic_gwilliams_cache(cache, n_subjects=3, n_sessions_per=1,
                                         C=12, rate=40, rec_sec=40.0,
                                         words_per_task=24, F=16, seed=2)
    raw = tg.load_gwilliams_cache(cache)
    j_tr, _ = jg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence")
    t_tr, _ = tg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence",
                                         device="cpu")
    return dict(cfg=cfg, cache=cache, j_tr=j_tr, t_tr=t_tr,
                loc=ch_locations_2d(cfg))


def _collate_cfgs(cfg):
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    rate = float(cfg.preprocs.brain_resample_rate)
    kw = dict(baseline_len_samp=int(rate * cfg.preprocs.baseline_len_sec),
              clamp_lim=float(cfg.preprocs.clamp_lim))
    return JCollate(**kw), CollateConfig(**kw)


def _pair(s, d_drop):
    """The JAX fused step with its initial state, and the port's fused step
    with a train state converted from it (weights, BN statistics, Adam)."""
    from meg_decoding_tpu.core.config import Config as JConfig
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_fused_speech_step as jfused
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig

    jds, ds, loc = s["j_tr"], s["t_tr"], s["loc"]
    sched = {"lr": LR, "epochs": 4, "lr_scheduler": "cosine"}
    jcol, tcol = _collate_cfgs(s["cfg"])
    jm = JEnc(loc=loc, num_subjects=3, D1=D1, D2=D2, F=16, K=K,
              d_drop=d_drop, seq2seq=True, num_blocks=NB)
    seg = jds.segment_table()[:4]
    example = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                      jds.speech_onsets, jds.session_subject,
                      jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                      jnp.zeros(4, jnp.int32), jds.seq_len)
    jopt_ = jopt(JConfig(sched), 3)
    js = jstate(jm, jopt_, example, jax.random.PRNGKey(0),
                init_temperature=TEMP0)
    jstep = jfused(jm, jopt_, JLoss(), jcol, jds)

    tm = TEnc(loc, 3, D1=D1, D2=D2, F=16, K=K, d_drop=d_drop, seq2seq=True,
              num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    with torch.no_grad():
        tm.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith("loss.")})
    topt = make_optimizer(Config(sched), 3)
    ts = create_train_state(tm, topt, init_temperature=TEMP0, seed=0)
    tstep = make_fused_speech_step(tm, topt, LossConfig(), tcol, ds)
    return jstep, js, tstep, ts


def _sessions(key, ds):
    return np.array(jax.random.randint(key, (BATCH,), 0, ds.num_sessions))


_NOISE_ONLY = re.compile(r"conv\d+\.(conv[01]\.bias|bn[01]\.mean)$")


def _assert_close_after_training(got: dict, want: dict, steps: int):
    """State dicts after ``steps`` updates, at the tolerances of the module
    docstring."""
    walk = 2.0 * steps * LR
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("spatial_attention.z_re"):
            np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0, atol=walk,
                                       err_msg=k)
            g, w = g[:, 1:], w[:, 1:]
        elif _NOISE_ONLY.search(k):
            np.testing.assert_allclose(g, w, rtol=0, atol=walk, err_msg=k)
            continue
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=k)


def test_fused_train_step_trajectory_matches_jax(train_setup):
    """12 steps from one converted init with a cosine schedule (3 updates
    per epoch, so the learning rate changes every third step)."""
    from meg_decoding_tpu_torch.interop import adam_state_from_jax

    s = train_setup
    jstep, js, tstep, ts = _pair(s, d_drop=0.0)
    rng = np.random.RandomState(7)
    for i in range(STEPS):
        idx = rng.randint(0, len(s["t_tr"]), BATCH)
        key = jax.random.PRNGKey(100 + i)
        js, jmet = jstep(js, jnp.asarray(idx), key)
        ts, met = tstep(ts, idx, sess_ids=_sessions(key, s["t_tr"]))
        assert float(met["skipped"]) == float(jmet["skipped"]) == 0.0
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
        np.testing.assert_allclose(float(met["temp"]), float(jmet["temp"]),
                                   rtol=1e-4, err_msg=f"step {i + 1}")
        if i == 0:
            for k in ("top1", "top10"):
                assert round(float(met[k]) * BATCH) == round(float(jmet[k]) * BATCH), k

    assert int(ts.step) == int(js.step) == STEPS
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    _assert_close_after_training(got, want, STEPS)
    jadam = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, js.opt_state))
    assert int(ts.opt_state.count) == int(jadam.count) == STEPS
    for k in jadam.mu:
        np.testing.assert_allclose(ts.opt_state.mu[k].numpy(),
                                   jadam.mu[k].numpy(), rtol=1e-2, atol=1e-5,
                                   err_msg=k)


def test_fused_train_step_with_spatial_dropout_matches_jax(train_setup,
                                                           monkeypatch):
    """One step with d_drop = 0.3: the JAX dropout mask is drawn from a key
    the test holds, and the port is handed the same centre."""
    import meg_decoding_tpu.models.layers as jlayers

    s = train_setup
    held = jax.random.PRNGKey(3)
    centre = int(jax.random.randint(held, (), 0, s["loc"].shape[0]))
    mask = jlayers.spatial_dropout_mask
    monkeypatch.setattr(jlayers, "spatial_dropout_mask",
                        lambda rng, loc, d_drop: mask(held, loc, d_drop))
    dropped = int((1.0 - np.asarray(mask(held, jnp.asarray(s["loc"]), 0.3))).sum())
    assert 1 < dropped < s["loc"].shape[0]

    jstep, js, tstep, ts = _pair(s, d_drop=0.3)
    # the same step without the mask gives another loss, so a mask the port
    # dropped would show
    _, _, nodrop_step, nodrop_state = _pair(s, d_drop=0.0)
    idx = np.random.RandomState(8).randint(0, len(s["t_tr"]), BATCH)
    key = jax.random.PRNGKey(9)
    sess = _sessions(key, s["t_tr"])
    js, jmet = jstep(js, jnp.asarray(idx), key)
    ts, met = tstep(ts, idx, sess_ids=sess, centre=centre)
    _, nodrop = nodrop_step(nodrop_state, idx, sess_ids=sess)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-3)
    assert abs(float(nodrop["loss"]) - float(jmet["loss"])) > 1e-3
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    want.pop("loss.temp")
    _assert_close_after_training(ts.model.state_dict(), want, 1)


def test_skipped_step_leaves_the_whole_state_unchanged(train_setup):
    """A NaN temperature makes the loss non-finite: the step counts as
    skipped and parameters, BN statistics and Adam state stay as they
    were, while the step counter moves on (as in JAX)."""
    s = train_setup
    _, _, tstep, ts = _pair(s, d_drop=0.1)
    with torch.no_grad():
        ts.temp.fill_(float("nan"))
    before = {k: v.clone() for k, v in ts.model.state_dict().items()}
    mu = {k: v.clone() for k, v in ts.opt_state.mu.items()}
    idx = np.arange(BATCH)
    ts, met = tstep(ts, idx, generator=torch.Generator().manual_seed(0))
    assert float(met["skipped"]) == 1.0
    assert float(met["loss"]) == float(met["top1"]) == float(met["top10"]) == 0.0
    for k, v in ts.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in ts.opt_state.mu.items():
        assert torch.equal(v, mu[k]), k
    assert int(ts.opt_state.count) == 0 and int(ts.step) == 1


# --- fit through the train CLI -------------------------------------------

def _cli_cfg(s, tmp_path, **kw):
    from meg_decoding_tpu_torch.core.config import Config, to_dict

    return Config(dict(to_dict(s["cfg"]), model="brain_encoder", D1=D1,
                       D2=D2, K=K, F=16, seq2seq=True, batch_size=BATCH,
                       updates=3, lr=LR, cache_dir=s["cache"],
                       save_root=str(tmp_path / "out"), **kw))


def _logged_epochs(save_root):
    rows = []
    runs = os.path.join(save_root, "runs")
    for run in sorted(os.listdir(runs)):
        with open(os.path.join(runs, run, "metrics.jsonl")) as f:
            rows += [json.loads(line) for line in f]
    return [r["epoch"] for r in rows], rows


def test_train_cli_writes_a_restorable_checkpoint_and_resumes(train_setup,
                                                             tmp_path):
    from meg_decoding_tpu_torch.cli.train_speech import run
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.models.factory import get_model
    from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state

    s = train_setup
    cfg = _cli_cfg(s, tmp_path, epochs=1, run_name="first")
    best = run(cfg, device="cpu")
    assert best["epoch"] == 0 and best["train_skipped"] == 0.0
    for k in ("train_loss", "test_loss"):
        assert np.isfinite(best[k])
    for k in ("train_top1", "train_top10", "test_top1", "test_top10"):
        assert 0.0 <= best[k] <= 1.0
    ckpt_dir = tmp_path / "out" / "ckpt"
    assert (ckpt_dir / "model_last.pt").exists()
    assert (ckpt_dir / "model_best.pt").exists()

    model = get_model(cfg, ch_locations_2d(cfg), device="cpu", seed=99)
    fresh = create_train_state(model, make_optimizer(cfg, 3), seed=99)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    restored = CheckpointManager(str(ckpt_dir)).restore("model_last", fresh)
    assert int(restored.step) == int(restored.opt_state.count) == 3
    assert not torch.equal(restored.model.conv0.conv0.weight,
                           init["conv0.conv0.weight"])
    assert not torch.equal(restored.model.conv0.bn0.mean, init["conv0.bn0.mean"])

    cfg2 = _cli_cfg(s, tmp_path, epochs=2, resume=True, run_name="second")
    run(cfg2, device="cpu")
    epochs, rows = _logged_epochs(str(tmp_path / "out"))
    assert epochs == [0, 1]
    assert all(r["train_skipped"] == 0.0 for r in rows)
    again = CheckpointManager(str(ckpt_dir)).restore("model_last", fresh)
    assert int(again.step) == 6

    # the eval CLI takes the trainer's model_best
    from meg_decoding_tpu_torch.cli.evaluate_speech import checkpoint_path
    from meg_decoding_tpu_torch.cli.evaluate_speech import run as evaluate

    assert checkpoint_path(cfg2).endswith("model_best.pt")
    res = evaluate(cfg2, device="cpu")
    assert 0.0 <= res["test_top1"] <= res["test_top10"] <= 1.0


def test_train_cli_refuses_to_checkpoint_an_all_skipped_epoch(train_setup,
                                                              tmp_path):
    from meg_decoding_tpu_torch.cli.train_speech import run

    cfg = _cli_cfg(train_setup, tmp_path, epochs=1,
                   init_temperature=float("nan"))
    with pytest.raises(FloatingPointError, match="skipped"):
        run(cfg, device="cpu")
    assert not (tmp_path / "out" / "ckpt" / "model_last.pt").exists()


def test_train_cli_refuses_unported_paths(train_setup, tmp_path):
    from meg_decoding_tpu_torch.cli.train_speech import run

    # host_resident and use_wandb are ported (tests/test_torch_port_spill.py)
    # data parallelism is ported (tests/test_torch_port_data_parallel.py);
    # a distributed: block without its rendezvous keys is refused
    with pytest.raises(ValueError, match="coordinator_address"):
        run(_cli_cfg(train_setup, tmp_path, epochs=1, distributed=True),
            device="cpu")
    # Brennan without its embedding stream embeds the audio (wav2vec2);
    # without audio either, it names the missing directory
    with pytest.raises(FileNotFoundError, match="no audio"):
        run(_cli_cfg(train_setup, tmp_path, epochs=1, dataset="Brennan2018",
                     root_dir=str(tmp_path / "no_data")), device="cpu")


def test_frozen_temperature_stays_at_its_init(train_setup):
    """``temp_trainable=False``: the temperature gets no gradient, so Adam
    leaves it at its initial value while the encoder trains."""
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig

    s = train_setup
    model = BrainEncoder(s["loc"], 3, D1=D1, D2=D2, F=16, K=K, seq2seq=True,
                         num_blocks=NB, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(Config({"lr": LR, "epochs": 1}), 3)
    state = create_train_state(model, opt, init_temperature=TEMP0)
    w0 = model.conv0.conv0.weight.detach().clone()
    step = make_fused_speech_step(model, opt, LossConfig(temp_trainable=False),
                                  _collate_cfgs(s["cfg"])[1], s["t_tr"])
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        state, met = step(state, np.arange(BATCH) + i, generator=gen)
        assert float(met["skipped"]) == 0.0
    assert torch.equal(state.temp.detach(), torch.tensor(TEMP0))
    assert not torch.equal(model.conv0.conv0.weight, w0)
