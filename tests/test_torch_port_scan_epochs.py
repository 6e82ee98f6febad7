"""The port's whole-epoch forms against the JAX package's scan epochs, on
the CPU: ``make_gwilliams_scan_epoch`` (with and without the cached collate
statistics) and ``make_scan_epoch`` (GOD) from one converted init, the
valid-step averaging of the epoch's metrics, ``fit_scan``'s two aborts,
both train CLIs with ``use_scan_epochs``, and the learning-rate schedule
the GOD trainers build.

JAX draws an epoch from one key: ``ikey, key = split(key)``; ``idx =
randint(ikey, (updates, B), 0, n)``; ``subkeys = split(key, updates)``;
step u's sessions ``randint(subkeys[u], (B,), 0, n_sessions)``.  The tests
recompute those draws and hand them to the port (``idx=``, ``sess_ids=``).
The encoders run with ``d_drop = 0``.

Tolerances, each with its reason:
* the epoch's mean loss rtol 1e-3 and mean temperature rtol 1e-4 (the
  speech trajectory test's per-step bounds,
  ``tests/test_torch_port_train_slice.py``); the mean top-1 / top-10
  within one hit of one batch; ``skipped`` exactly equal; the state after
  the epoch as that test holds it;
* the averaging of given metric rows — rtol 1e-6 (f32 sums of a few terms);
* the learning rate at every step — rtol 1e-6 (f32 cosine on both sides).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_collate_stats import stats_setup  # noqa: F401
from tests.test_torch_port_god_train import _cli_cfg as _god_cli_cfg
from tests.test_torch_port_god_train import god_setup  # noqa: F401
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _collate_cfgs,
    _logged_epochs,
    train_setup,  # noqa: F401
)
from tests.test_torch_port_train_slice import _cli_cfg as _speech_cli_cfg

D1, D2, K, NB, BATCH, LR, TEMP0, UPDATES = 16, 24, 4, 2, 16, 1e-3, 5.1, 3
SCHED = {"lr": LR, "epochs": 4, "lr_scheduler": "cosine"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_draws(key, n: int, n_sessions: int | None):
    """The draws of one JAX scan epoch (``_build_epoch`` and the
    Gwilliams gather)."""
    ikey, key = jax.random.split(key)
    idx = np.asarray(jax.random.randint(ikey, (UPDATES, BATCH), 0, n))
    if n_sessions is None:
        return idx, None
    subkeys = jax.random.split(key, UPDATES)
    sess = np.stack([np.asarray(jax.random.randint(k, (BATCH,), 0, n_sessions))
                     for k in subkeys])
    return idx, sess


def _converted(js, tm):
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})


def _assert_epoch_close(js, jmeans, ts, means):
    assert float(means["skipped"]) == float(jmeans["skipped"]) == 0.0
    np.testing.assert_allclose(float(means["loss"]), float(jmeans["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(means["temp"]), float(jmeans["temp"]),
                               rtol=1e-4)
    for k in ("top1", "top10"):
        assert abs(float(means[k]) - float(jmeans[k])) <= 1.0 / (BATCH * UPDATES) + 1e-6, k
    assert int(ts.step) == int(js.step) == UPDATES
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    _assert_close_after_training(got, want, UPDATES)


@pytest.mark.parametrize("cache_stats", [False, True], ids=["inline", "cached"])
def test_gwilliams_scan_epoch_matches_jax(stats_setup, cache_stats):
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_gwilliams_scan_epoch as jscan
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.scan_loop import make_gwilliams_scan_epoch
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig

    s = stats_setup
    jds, ds = s["j_tr"], s["t_tr"]
    jcol, tcol = _collate_cfgs(s["cfg"])
    jm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=True, num_blocks=NB)
    seg = jds.segment_table()[:4]
    example = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                      jds.speech_onsets, jds.session_subject,
                      jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                      jnp.zeros(4, jnp.int32), jds.seq_len)
    jo = jopt(JConfig(SCHED), 2)
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    jepoch = jscan(jm, jo, JLoss(), jcol, jds, updates=UPDATES,
                   batch_size=BATCH, cache_collate_stats=cache_stats)
    tm = TEnc(s["loc"], 2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0, seq2seq=True,
              num_blocks=NB, device="cpu")
    _converted(js, tm)
    to = make_optimizer(Config(SCHED), 2)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tepoch = make_gwilliams_scan_epoch(tm, to, LossConfig(), tcol, ds,
                                       updates=UPDATES, batch_size=BATCH,
                                       cache_collate_stats=cache_stats)
    assert (tepoch.collate_stats is not None) == cache_stats

    key = jax.random.PRNGKey(31)
    idx, sess = _jax_draws(key, len(ds), ds.num_sessions)
    js, jmeans = jepoch(js, key)
    ts, means = tepoch(ts, idx=idx, sess_ids=sess)
    _assert_epoch_close(js, jmeans, ts, means)


def test_god_scan_epoch_matches_jax(god_setup):
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_scan_epoch as jscan
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu_torch.data.packed import PackedDataset
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.scan_loop import make_scan_epoch
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import CollateConfig, LossConfig

    s = god_setup
    jds = s["jds"]
    arrs = [np.asarray(a) for a in (jds.X, jds.Y, jds.subject_idxs)]
    ds = PackedDataset(X=torch.from_numpy(arrs[0]), Y=torch.from_numpy(arrs[1]),
                       subject_idxs=torch.from_numpy(arrs[2]).long(),
                       num_subjects=2)
    kw = dict(baseline_len_samp=5, clamp_lim=20.0)
    jm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=False, num_blocks=NB)
    example = tuple(jnp.asarray(a[:4]) for a in arrs)
    jo = jopt(JConfig(SCHED), 2)
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    jepoch = jscan(jm, jo, JLoss(), JCollate(**kw), jds, updates=UPDATES,
                   batch_size=BATCH)
    tm = TEnc(s["loc"], 2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0, seq2seq=False,
              num_blocks=NB, device="cpu")
    _converted(js, tm)
    to = make_optimizer(Config(SCHED), 2)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tepoch = make_scan_epoch(tm, to, LossConfig(), CollateConfig(**kw), ds,
                             updates=UPDATES, batch_size=BATCH)
    key = jax.random.PRNGKey(32)
    idx, _ = _jax_draws(key, len(ds), None)
    js, jmeans = jepoch(js, key)
    ts, means = tepoch(ts, idx=idx)
    _assert_epoch_close(js, jmeans, ts, means)


def test_scan_epochs_draw_from_the_generator(stats_setup):
    """Without explicit draws an epoch takes (updates, B) segment ids, then
    (updates, B) sessions, from the generator it is given; the same seed
    trains the same epoch."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.scan_loop import make_gwilliams_scan_epoch
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig

    s = stats_setup
    ds = s["t_tr"]
    out = []
    for with_draws in (False, True):
        model = BrainEncoder(s["loc"], 2, D1=D1, D2=D2, F=16, K=K,
                             seq2seq=True, num_blocks=NB, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(Config(SCHED), 2)
        state = create_train_state(model, opt, init_temperature=TEMP0)
        epoch = make_gwilliams_scan_epoch(model, opt, LossConfig(),
                                          _collate_cfgs(s["cfg"])[1], ds,
                                          updates=UPDATES, batch_size=BATCH)
        gen = torch.Generator().manual_seed(5)
        if with_draws:
            idx = torch.randint(0, len(ds), (UPDATES, BATCH), generator=gen)
            sess = torch.randint(0, ds.num_sessions, (UPDATES, BATCH),
                                 generator=gen)
            _, means = epoch(state, idx=idx, sess_ids=sess)
        else:
            _, means = epoch(state, gen)
        out.append(means)
    assert {k: float(v) for k, v in out[0].items()} == \
        {k: float(v) for k, v in out[1].items()}
    with pytest.raises(ValueError, match="draws or a torch.Generator"):
        epoch(state)


# --- the valid-step averaging ---------------------------------------------------

ROWS = {"loss": [2.0, 0.0, 4.0, 0.0, 3.0], "temp": [5.0, 5.1, 5.2, 5.3, 5.4],
        "skipped": [0.0, 1.0, 0.0, 1.0, 0.0], "top1": [0.5, 0.0, 0.25, 0.0, 1.0]}


@pytest.mark.parametrize("rows", [ROWS, dict(ROWS, skipped=[1.0] * 5,
                                             loss=[0.0] * 5, top1=[0.0] * 5)],
                         ids=["some_skipped", "all_skipped"])
def test_epoch_means_match_jax_build_epoch(rows):
    """A fake step whose metrics (masked to 0 where skipped) are given:
    ``temp`` and ``skipped`` take the plain mean, the rest sum over
    max(updates − Σ skipped, 1)."""
    from meg_decoding_tpu.train.scan_loop import _build_epoch
    from meg_decoding_tpu_torch.train.scan_loop import epoch_means

    n = len(rows["loss"])
    table = {k: jnp.asarray(v, jnp.float32) for k, v in rows.items()}

    def step_fn(state, i):
        return state + 1, {k: v[state] for k, v in table.items()}

    jepoch = _build_epoch(step_fn, lambda i, key: (i,), n, 2, 7, ())
    _, want = jepoch(jnp.int32(0), jax.random.PRNGKey(0))
    history = [{k: torch.tensor(v[u]) for k, v in rows.items()}
               for u in range(n)]
    got = epoch_means(history, n)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


# --- fit_scan -----------------------------------------------------------------

@pytest.mark.parametrize("means,match", [
    ({"loss": 0.0, "temp": 5.0, "skipped": 1.0}, "skipped"),
    ({"loss": float("nan"), "temp": 5.0, "skipped": 0.0}, "non-finite"),
], ids=["all_skipped", "nan_loss"])
def test_fit_scan_aborts_before_the_checkpoint(tmp_path, means, match):
    from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
    from meg_decoding_tpu_torch.train.loop import fit_scan
    from meg_decoding_tpu_torch.utils.logging import RunLogger

    calls = []

    def scan_epoch(state, generator):
        calls.append(generator.device)
        return state, {k: torch.tensor(v) for k, v in means.items()}

    def eval_step(*a):
        raise AssertionError("an aborted epoch is not evaluated")

    state = types.SimpleNamespace(step=torch.zeros((), dtype=torch.int32))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = Config({"epochs": 2, "batch_size": 4, "test_size": 4})
    with pytest.raises(FloatingPointError, match=match):
        fit_scan(cfg, range(8), range(8), state, scan_epoch, eval_step,
                 RunLogger(str(tmp_path)), ckpt)
    assert calls == [torch.device("cpu")]
    assert not ckpt.exists("model_last")


# --- the CLIs --------------------------------------------------------------------

def test_speech_cli_scan_epochs(train_setup, tmp_path):
    """``use_scan_epochs`` on the sentence split runs ``fit_scan`` (its rows
    carry no per-step timers), with and without the cached statistics; on a
    shallow split it keeps the per-step fused driver, as in JAX."""
    from meg_decoding_tpu_torch.cli.train_speech import run

    s = train_setup
    for i, cache in enumerate((False, True)):
        cfg = _speech_cli_cfg(s, tmp_path / f"run{i}", epochs=2,
                              use_scan_epochs=True, cache_collate_stats=cache)
        run(cfg, device="cpu")
        epochs, rows = _logged_epochs(cfg.save_root)
        assert epochs == [0, 1]
        assert all(r["train_skipped"] == 0.0 and np.isfinite(r["train_loss"])
                   and "train_t_step_ms" not in r and "t_step_ms" not in r
                   for r in rows)
    cfg = _speech_cli_cfg(s, tmp_path / "shallow", epochs=1,
                          use_scan_epochs=True, split_mode="shallow")
    run(cfg, device="cpu")
    assert "t_step_ms" in _logged_epochs(cfg.save_root)[1][0]


def test_god_cli_scan_epochs(god_setup, tmp_path):
    """``use_scan_epochs`` runs ``fit_scan`` for the CLIP loss (3 updates an
    epoch: ``updates``, drawn with replacement); a loss with labels keeps
    the per-step ``fit``, as in JAX."""
    from meg_decoding_tpu_torch.cli import train_god
    from meg_decoding_tpu_torch.models.factory import get_model
    from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from tests.test_torch_port_god_train import _rows

    s = god_setup
    cfg = _god_cli_cfg(s, tmp_path, epochs=2, use_scan_epochs=True, updates=3)
    best = train_god.run(cfg, device="cpu")
    rows = _rows(cfg.save_root)
    assert [r["epoch"] for r in rows] == [0, 1]
    assert all("t_step_ms" not in r and r["train_skipped"] == 0.0 for r in rows)
    assert np.isfinite(best["test_loss"])
    model = get_model(cfg, s["loc"], device="cpu", seed=1)
    fresh = create_train_state(model, make_optimizer(cfg, 3), seed=1)
    ckpt = CheckpointManager(str(tmp_path / "out" / "ckpt"))
    assert int(ckpt.restore("model_last", fresh).step) == 6

    cfg = _god_cli_cfg(s, tmp_path, epochs=1, use_scan_epochs=True,
                       loss={"kind": "clip", "same_label_weight": 0.5},
                       save_root=str(tmp_path / "labels"))
    train_god.run(cfg, device="cpu")
    assert "t_step_ms" in _rows(cfg.save_root)[0]


# --- the learning-rate schedule ---------------------------------------------------

def test_god_lr_schedule_counts_updates_as_an_epoch_like_jax(god_setup, tmp_path,
                                                            monkeypatch):
    """``use_sampler: false, lr_scheduler: cosine``: an epoch runs
    len(train) // batch steps, but both trainers build the schedule with
    ``updates`` steps an epoch (JAX ``cli/train_god.py:114-115``,
    ``train/schedules.py:28``); the port's learning rate equals JAX's at
    every step of the run."""
    from meg_decoding_tpu.cli import train_god as jcli
    from meg_decoding_tpu.train.schedules import make_schedule as jsched
    from meg_decoding_tpu_torch.cli import train_god as tcli
    from meg_decoding_tpu_torch.train.loop import steps_per_epoch
    from meg_decoding_tpu_torch.train.schedules import make_schedule

    class Built(Exception):
        pass

    seen = {}

    def spy(side):
        def make_optimizer(cfg, updates_per_epoch):
            seen[side] = updates_per_epoch
            raise Built
        return make_optimizer

    monkeypatch.setattr(jcli, "make_optimizer", spy("jax"))
    monkeypatch.setattr(tcli, "make_optimizer", spy("port"))
    cfg = _god_cli_cfg(god_setup, tmp_path, epochs=3, use_sampler=False,
                       lr_scheduler="cosine", updates=5)
    with pytest.raises(Built):
        jcli.run(JConfig(to_dict(cfg)))
    with pytest.raises(Built):
        tcli.run(Config(to_dict(cfg)), device="cpu")
    assert seen == {"jax": 5, "port": 5}
    n_train = 2 * int(round(40 * 5 / 6))      # the cv split of 2 × 40 epochs
    per_epoch = steps_per_epoch(cfg, n_train)  # 66 // 16 = 4 steps, not 5
    assert per_epoch == 4
    jfn = jsched(JConfig(to_dict(cfg)), seen["jax"])
    tfn = make_schedule(cfg, seen["port"])
    lrs = []
    for count in range(int(cfg.epochs) * per_epoch + 1):
        lr = float(tfn(torch.tensor(count)))
        np.testing.assert_allclose(lr, float(jfn(jnp.asarray(count))),
                                   rtol=1e-6, err_msg=f"step {count}")
        lrs.append(lr)
    # the rate first changes after `updates` = 5 steps, inside epoch 1
    assert lrs[4] == lrs[0] and lrs[5] < lrs[0]
