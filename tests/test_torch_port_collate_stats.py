"""The port's cached collate statistics against the JAX package, on the
CPU: the sweep's table (``data/gwilliams.py:compute_collate_stats``), the
cached collate against the inline one, the fused step with
``cache_collate_stats`` against JAX's, and the speed presets
(``configs/throughput.yaml``, ``configs/throughput_exact.yaml``) through the
port's train CLI.

The cache holds 2 subjects × 2 sessions (C = 12 at 40 Hz, T = 120), the
sentence split's training set; the sweep runs in chunks of 48 windows, so
there are several, the last one partial.  JAX's table is lane-padded
((·, 2·Cp), Cp = 128) and chunk-padded; the port's is (S·NT·W, 2C): the
test compares the rows and columns both define.

Tolerances, each with its reason:
* the table — without a baseline, ≤ 2 ulp per entry: the port's
  percentiles are the quantile kernel's blend ``fma(v_lo, w_lo,
  v_hi·w_hi)``, JAX's CPU default sorts and blends ``v_lo·(1 − f) +
  v_hi·f`` (ROADMAP Queue 3); with the config's 0.5 s baseline, the IQR
  ≤ 2 ulp and every entry within 2 ulp of the window channel's max |x|:
  XLA and torch sum the baseline mean in another order, which shifts the
  whole corrected window by up to an ulp of its values, and a median near
  0 is many of its own ulps away from its neighbours;
* cached vs inline collate in the port — bit-identical: both call one
  quantile function on the same baseline-corrected values, and the
  transform ``(x − med) / iqr`` is the same op;
* the fused step with cached statistics against JAX's, 4 steps — loss rtol
  1e-3 at every step, top-k at step 1 exactly equal, the state as the
  speech trajectory test holds it (``tests/test_torch_port_train_slice.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _collate_cfgs,
)

D1, D2, K, NB, BATCH, LR, TEMP0, CHUNK = 16, 24, 4, 2, 16, 1e-3, 5.1, 48


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def stats_setup(tmp_path_factory):
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache

    cache = str(tmp_path_factory.mktemp("gw_stats") / "cache")
    cfg = make_synthetic_gwilliams_cache(cache, n_subjects=2, n_sessions_per=2,
                                         C=12, rate=40, rec_sec=40.0,
                                         words_per_task=24, F=16, seed=4)
    raw = tg.load_gwilliams_cache(cache)
    j_tr, _ = jg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence")
    t_tr, _ = tg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence",
                                         device="cpu")
    bl = _collate_cfgs(cfg)[1].baseline_len_samp
    return dict(cfg=cfg, cache=cache, j_tr=j_tr, t_tr=t_tr, bl=bl,
                loc=ch_locations_2d(cfg))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    def ordered(x):
        k = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(k < 0, -(k & 0x7FFFFFFF), k)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("baseline", [False, True], ids=["raw", "baseline"])
def test_stats_table_matches_jax(stats_setup, baseline):
    from meg_decoding_tpu.data.gwilliams import compute_collate_stats as jstats
    from meg_decoding_tpu.data.gwilliams import stats_lane_pad
    from meg_decoding_tpu_torch.data.gwilliams import compute_collate_stats
    from meg_decoding_tpu_torch.ops.kernels.window_gather import window_gather

    s = stats_setup
    ds = s["t_tr"]
    bl = s["bl"] if baseline else 0
    S, NT, C, T = ds.recordings.shape
    W = int(ds.meg_onsets.shape[2])
    total = S * NT * W
    assert S == 4 and total % CHUNK != 0 and total > 3 * CHUNK
    got = compute_collate_stats(ds, bl, chunk=CHUNK).numpy()
    assert got.shape == (total, 2 * C)
    jt = np.asarray(jstats(s["j_tr"], bl, chunk=CHUNK))
    Cp = stats_lane_pad(C)
    assert jt.shape[0] >= total
    want = np.concatenate([jt[:total, :C], jt[:total, Cp:Cp + C]], axis=1)
    assert _ulps(got[:, C:], want[:, C:]) <= 2                # IQR
    if not baseline:
        assert _ulps(got, want) <= 2
    else:
        windows = window_gather(
            ds.recordings.reshape(S * NT, C, T),
            torch.arange(S * NT).repeat_interleave(W),
            ds.meg_onsets.reshape(total), ds.seq_len).numpy()
        ulp = np.spacing(np.abs(windows).max(axis=-1))        # (total, C)
        assert (np.abs(got - want) <= 2 * np.tile(ulp, 2)).all()
    # the chunking does not enter: one chunk gives the same table
    one = compute_collate_stats(ds, bl, chunk=total).numpy()
    np.testing.assert_array_equal(one, got)


def test_cached_collate_is_bit_identical_to_the_inline_collate(stats_setup):
    from meg_decoding_tpu_torch.data.gwilliams import (
        _gather_batch,
        collate_stats_rows,
        compute_collate_stats,
    )
    from meg_decoding_tpu_torch.ops.scaling import (
        collate_preprocess,
        collate_preprocess_cached,
    )

    s = stats_setup
    ds = s["t_tr"]
    table = compute_collate_stats(ds, s["bl"], chunk=CHUNK)
    rng = np.random.RandomState(9)
    seg = torch.as_tensor(ds.segment_table()[rng.randint(0, len(ds), 48)])
    sess = torch.as_tensor(rng.randint(0, ds.num_sessions, 48))
    X, _, _ = _gather_batch(ds.recordings, ds.y_stream, ds.meg_onsets,
                            ds.speech_onsets, ds.session_subject, seg[:, 0],
                            seg[:, 1], sess, ds.seq_len)
    rows = collate_stats_rows(ds, table, seg[:, 0], seg[:, 1], sess)
    C = X.shape[1]
    for clamp in (True, False):
        inline = collate_preprocess(X, s["bl"], 20.0, clamp)
        cached = collate_preprocess_cached(X, rows[:, :C], rows[:, C:], s["bl"],
                                           20.0, clamp)
        assert torch.equal(cached, inline)


def _pair(s):
    """The JAX fused step with cached statistics and its initial state, and
    the port's from the same init."""
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
    sched = {"lr": LR, "epochs": 4, "lr_scheduler": "none"}
    jcol, tcol = _collate_cfgs(s["cfg"])
    jm = JEnc(loc=loc, num_subjects=2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0,
              seq2seq=True, num_blocks=NB)
    seg = jds.segment_table()[:4]
    example = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                      jds.speech_onsets, jds.session_subject,
                      jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                      jnp.zeros(4, jnp.int32), jds.seq_len)
    jo = jopt(JConfig(sched), 3)
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    jstep = jfused(jm, jo, JLoss(), jcol, jds, cache_collate_stats=True)

    tm = TEnc(loc, 2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0, seq2seq=True,
              num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    to = make_optimizer(Config(sched), 3)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tstep = make_fused_speech_step(tm, to, LossConfig(), tcol, ds,
                                   cache_collate_stats=True)
    return jstep, js, tstep, ts


def test_fused_step_with_cached_stats_matches_jax(stats_setup):
    from meg_decoding_tpu_torch.data.gwilliams import compute_collate_stats

    s = stats_setup
    jstep, js, tstep, ts = _pair(s)
    ds = s["t_tr"]
    np.testing.assert_array_equal(tstep.collate_stats.numpy(),
                                  compute_collate_stats(ds, s["bl"]).numpy())
    assert jstep.collate_stats is not None
    rng = np.random.RandomState(11)
    steps = 4
    for i in range(steps):
        idx = rng.randint(0, len(ds), BATCH)
        key = jax.random.PRNGKey(200 + i)
        sess = np.array(jax.random.randint(key, (BATCH,), 0, ds.num_sessions))
        js, jmet = jstep(js, jnp.asarray(idx), key)
        ts, met = tstep(ts, idx, sess_ids=sess)
        assert float(met["skipped"]) == float(jmet["skipped"]) == 0.0
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
        if i == 0:
            for k in ("top1", "top10"):
                assert round(float(met[k]) * BATCH) == round(float(jmet[k]) * BATCH), k
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    _assert_close_after_training(got, want, steps)


def test_fused_step_takes_a_given_table_and_draws_sessions(stats_setup):
    """``collate_stats=`` reuses a table without a sweep; with a generator
    the step draws its sessions, and the cached and inline steps from one
    state, batch and sessions give the same loss."""
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.data.gwilliams import compute_collate_stats
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig

    s = stats_setup
    ds = s["t_tr"]
    table = compute_collate_stats(ds, s["bl"])
    losses = []
    for kw in ({"collate_stats": table}, {}):
        model = BrainEncoder(s["loc"], 2, D1=D1, D2=D2, F=16, K=K, seq2seq=True,
                             num_blocks=NB, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(Config({"lr": LR, "epochs": 1}), 3)
        state = create_train_state(model, opt, init_temperature=TEMP0)
        step = make_fused_speech_step(model, opt, LossConfig(),
                                      _collate_cfgs(s["cfg"])[1], ds, **kw)
        assert step.collate_stats is kw.get("collate_stats")
        state, met = step(state, np.arange(BATCH),
                          generator=torch.Generator().manual_seed(3))
        losses.append(float(met["loss"]))
    assert losses[0] == losses[1]


@pytest.mark.parametrize("preset", ["throughput", "throughput_exact"])
def test_speed_presets_run_through_the_train_cli(stats_setup, tmp_path, preset):
    """The published presets (bf16, cached collate statistics, tanh or
    erf_poly GELU) through ``main`` at the test widths, batch 16, on the
    test cache (40 Hz, F = 16 features, so ``last4layers`` is off): every
    key they set is taken."""
    from meg_decoding_tpu_torch.cli import train_speech

    s = stats_setup
    best = train_speech.main([
        "--config-name", preset, "--device", "cpu",
        f"cache_dir={s['cache']}", f"save_root={tmp_path / 'out'}",
        "epochs=1", "updates=2", f"batch_size={BATCH}", f"D1={D1}",
        f"D2={D2}", f"K={K}", "F=16", "preprocs.brain_resample_rate=40",
        "preprocs.last4layers=false", "run_name=preset"])
    assert best["train_skipped"] == 0.0
    assert np.isfinite(best["train_loss"]) and np.isfinite(best["test_loss"])
