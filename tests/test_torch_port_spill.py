"""The port's host-spill training path against the JAX package on the CPU:
``data/prefetch.py``, ``PackedDataset.to_host``, ``BrennanPacked.to_host``,
``data/gwilliams.py:to_host`` and its host gather, ``fit``'s prefetch
branch and profile window, and the wandb fallback of ``RunLogger``.

* ``prefetch_to_device``: the cases of ``tests/test_prefetch.py`` (order,
  the producer's exception at the consumer, overlap, a custom put, the size
  check, a worker that stops when the iterator is abandoned); on the CPU
  the default put is the identity.
* The host gathers: the port's Gwilliams host gather equals JAX's
  ``_gather_batch_host`` bit for bit, also at an onset between
  T − padded_window(L) and T − L, where both clamp to T − L and the device
  gather to T − padded_window(L) (ROADMAP Queue 3); the packed and Brennan
  host gathers equal their device gathers.
* Sentence splits share their recordings: spilled through one buffer
  cache, they share one host copy.
* Trajectories: 6 unfused speech steps and 8 GOD steps on host-gathered
  batches streamed through the prefetch, against JAX's steps on JAX's host
  gathers of the same draws, from one converted init: loss rtol 1e-3 and
  the state at ``_assert_close_after_training``'s tolerances, as the
  existing trajectory tests.
* The train CLIs with ``host_resident: true`` log exactly what the
  device-resident per-step runs log (as JAX's ``tests/test_prefetch.py``
  holds its trainers), with the profile window on and wandb asked for.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.data.prefetch import prefetch_to_device
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_god_train import (
    _state_dicts,
    god_setup,  # noqa: F401
)
from tests.test_torch_port_god_train import _pair as _god_pair
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _collate_cfgs,
    _logged_epochs,
    train_setup,  # noqa: F401
)
from tests.test_torch_port_train_slice import _cli_cfg as _speech_cli_cfg

D1, D2, K, NB, BATCH, LR, TEMP0 = 16, 24, 4, 2, 16, 1e-3, 5.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- prefetch_to_device ----------------------------------------------------

def test_prefetch_yields_all_batches_in_order():
    batches = [(torch.full((4, 3), float(i)), {"i": torch.tensor(i)}, i)
               for i in range(7)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert len(out) == 7
    for i, (x, d, n) in enumerate(out):
        assert torch.equal(x, batches[i][0]) and int(d["i"]) == n == i


def test_prefetch_raises_the_producers_exception():
    def gen():
        yield torch.zeros(3)
        raise RuntimeError("bad shard")

    it = prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="bad shard"):
        next(it)
        next(it)


def test_prefetch_overlaps_production_with_consumption():
    """With size 2 the producer runs ahead: the wall time is near
    max(produce, consume), not their sum."""
    delay, n = 0.05, 8

    def gen():
        for i in range(n):
            time.sleep(delay)
            yield torch.full((2,), float(i))

    t0 = time.time()
    for _ in prefetch_to_device(gen(), size=2, device="cpu"):
        time.sleep(delay)
    dt = time.time() - t0
    assert dt < 1.7 * n * delay, dt


def test_prefetch_takes_a_custom_put():
    seen = []

    def put(batch):
        seen.append(threading.current_thread().name)
        return tuple(2 * t for t in batch)

    batches = [(torch.arange(4.0) + i,) for i in range(3)]
    out = list(prefetch_to_device(iter(batches), size=2, device_put=put))
    assert [torch.equal(o[0], 2 * b[0]) for o, b in zip(out, batches)] == [True] * 3
    assert len(seen) == 3 and threading.main_thread().name not in seen


def test_prefetch_size_is_checked():
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter([]), size=0, device="cpu"))


def test_prefetch_worker_stops_when_the_iterator_is_abandoned():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield torch.full((4,), float(i))

    before = {t.ident for t in threading.enumerate()}
    it = prefetch_to_device(gen(), size=2, device="cpu")
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline:
        extra = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, "prefetch worker still alive after iterator close"
    assert len(produced) < 1000


def test_prefetch_to_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prefetch_to_device(iter([]), size=2)


# --- host gathers ------------------------------------------------------------

def _sessions(key, n_sessions, n):
    return np.array(jax.random.randint(key, (n,), 0, n_sessions))


def test_gwilliams_host_gather_matches_jax_host_gather(train_setup):
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu_torch.data import gwilliams as tg

    s = train_setup
    jhost, thost = jg.to_host(s["j_tr"]), tg.to_host(s["t_tr"])
    assert thost.host_resident and not s["t_tr"].host_resident
    rng = np.random.RandomState(4)
    for i in range(3):
        ids = rng.randint(0, len(thost), 12)
        key = jax.random.PRNGKey(i)
        jX, jY, jsubs, _ = jg.gather_speech_batch(jhost, ids, key)
        sess = _sessions(key, thost.num_sessions, len(ids))
        X, Y, subs, seg = tg.gather_speech_batch(thost, ids, sess_ids=sess)
        assert np.array_equal(X.numpy(), jX) and np.array_equal(Y.numpy(), jY)
        assert np.array_equal(subs.numpy(), jsubs) and np.array_equal(seg, ids)
        # and the device gather of the same draw
        dX, dY, dsubs, _ = tg.gather_speech_batch(s["t_tr"], ids, sess_ids=sess)
        assert torch.equal(dX, X) and torch.equal(dY, Y) and torch.equal(dsubs, subs)


def test_host_gather_clamps_to_T_minus_L_like_jax(train_setup):
    """An onset between T − padded_window(L) and T − L, with data in the
    padding so that the clamp shows: the host gathers (both packages) cut
    the window at T − L, the device gather at T − padded_window(L)."""
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.ops.kernels.window_gather import padded_window

    s = train_setup
    jhost, thost = jg.to_host(s["j_tr"]), tg.to_host(s["t_tr"])
    L, T = int(thost.seq_len), int(thost.recordings.shape[-1])
    onset = T - padded_window(L) + (padded_window(L) - L) // 2
    assert T - padded_window(L) < onset < T - L
    rec = np.random.RandomState(5).randn(*thost.recordings.shape).astype(np.float32)
    mo = thost.meg_onsets.numpy().copy()
    mo[1, 2, 3] = T - L + 5  # past T − L: clamped to T − L
    mo[0, 1, 2] = onset
    jhost.recordings, jhost.meg_onsets = rec, mo
    thost.recordings = torch.from_numpy(rec)
    thost.meg_onsets = torch.from_numpy(mo)
    task, i_in, sess = np.array([1, 2, 1]), np.array([2, 3, 0]), np.array([0, 1, 2])
    jX, jY, jsubs = jg._gather_batch_host(jhost, task, i_in, sess)
    X, Y, subs = tg._gather_batch_host(thost, task, i_in, sess)
    assert np.array_equal(X.numpy(), jX) and np.array_equal(Y.numpy(), jY)
    assert np.array_equal(subs.numpy(), jsubs)
    assert np.array_equal(X[0].numpy(), rec[0, 1, :, onset:onset + L])
    assert np.array_equal(X[1].numpy(), rec[1, 2, :, T - L:])
    # the device gather of the same source clamps lower (Queue 3)
    dev = tg.GwilliamsPacked(**{**vars(thost), "host_resident": False})
    dX, _, _ = tg._gather_batch(
        dev.recordings, dev.y_stream, dev.meg_onsets, dev.speech_onsets,
        dev.session_subject, torch.as_tensor(task), torch.as_tensor(i_in),
        torch.as_tensor(sess), L)
    lo = T - padded_window(L)
    assert np.array_equal(dX[0].numpy(), rec[0, 1, :, lo:lo + L])
    assert not torch.equal(dX[0], X[0])


def test_spilled_sentence_splits_share_one_host_copy(tmp_path):
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.data.synthetic import (
        make_synthetic_gwilliams_cache,
    )

    cache = str(tmp_path / "cache")
    cfg = make_synthetic_gwilliams_cache(cache, n_subjects=2, n_sessions_per=1,
                                         C=6, rate=40, rec_sec=20.0,
                                         words_per_task=12, F=8, seed=1)
    train, test = tg.build_gwilliams_dataset(cfg, *tg.load_gwilliams_cache(cache),
                                             split_mode="sentence", device="cpu")
    assert train.recordings is test.recordings  # the aliasing of the splits
    cache_ = {}
    train_h, test_h = tg.to_host(train, cache_), tg.to_host(test, cache_)
    assert train_h.recordings is test_h.recordings
    assert train_h.y_stream is test_h.y_stream
    assert train_h.session_subject is test_h.session_subject
    assert train_h.meg_onsets is not test_h.meg_onsets
    assert torch.equal(train_h.recordings, train.recordings)
    assert tg.to_host(train_h) is train_h  # spilling twice is a no-op


def test_packed_and_brennan_host_gathers_equal_device_gathers():
    from meg_decoding_tpu_torch.data.brennan import BrennanPacked
    from meg_decoding_tpu_torch.data.packed import PackedDataset

    rng = np.random.RandomState(6)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    ds = PackedDataset(X=t(20, 4, 6), Y=t(20, 5),
                       subject_idxs=torch.from_numpy(rng.randint(0, 2, 20)),
                       labels=torch.from_numpy(rng.randint(1, 9, 20)),
                       num_subjects=2)
    host = ds.to_host()
    assert host.host_resident and not ds.host_resident
    idx = rng.randint(0, 20, 7)
    for a, b in zip(host.gather(idx), ds.gather(idx)):
        assert torch.equal(a, b)
    sub = host.subset(np.arange(5, 15))
    assert sub.host_resident and torch.equal(sub.X, ds.X[5:15])
    br = BrennanPacked(t(10, 3, 4, 6), t(10, 5, 6))
    bh = br.to_host()
    assert bh.host_resident and not br.host_resident
    idx, subs = rng.randint(0, 10, 6), rng.randint(0, 3, 6)
    for a, b in zip(bh.gather(idx, subject_idxs=subs)[:3],
                    br.gather(idx, subject_idxs=subs)[:3]):
        assert torch.equal(a, b)
    bsub = bh.subset([1, 4])
    assert bsub.host_resident and torch.equal(bsub.Y, br.Y[[1, 4]])


# --- trajectories against JAX's spill runs -------------------------------------

def test_speech_spill_trajectory_matches_jax(train_setup):
    """6 unfused steps on host-gathered Gwilliams batches through the
    prefetch, against JAX's unfused steps on its host gathers of the same
    draws (``d_drop`` 0, one converted init)."""
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_train_step as jmake
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_train_step

    s = train_setup
    jhost, thost = jg.to_host(s["j_tr"]), tg.to_host(s["t_tr"])
    jcol, tcol = _collate_cfgs(s["cfg"])
    sched = {"lr": LR, "epochs": 3, "lr_scheduler": "cosine"}
    jm = JEnc(loc=s["loc"], num_subjects=3, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=True, num_blocks=NB)
    jo = jopt(JConfig(sched), 2)
    ex = jg.gather_speech_batch(jhost, np.arange(4), jax.random.PRNGKey(9))[:3]
    js = jstate(jm, jo, tuple(jnp.asarray(a) for a in ex), jax.random.PRNGKey(0),
                init_temperature=TEMP0)
    jstep = jmake(jm, jo, JLoss(), jcol)
    tm = TEnc(s["loc"], 3, D1=D1, D2=D2, F=16, K=K, d_drop=0.0, seq2seq=True,
              num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    to = make_optimizer(Config(sched), 2)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tstep = make_train_step(tm, to, LossConfig(), tcol)

    rng = np.random.RandomState(11)
    draws = [(rng.randint(0, len(thost), BATCH), jax.random.PRNGKey(100 + i))
             for i in range(6)]

    def host_batches():
        for ids, key in draws:
            sess = _sessions(key, thost.num_sessions, BATCH)
            yield tg.gather_speech_batch(thost, ids, sess_ids=sess)[:3]

    steps = 0
    for (ids, key), batch in zip(draws, prefetch_to_device(host_batches(),
                                                           device="cpu")):
        jX, jY, jsubs, _ = jg.gather_speech_batch(jhost, ids, key)
        assert np.array_equal(batch[0].numpy(), jX)
        js, jmet = jstep(js, jnp.asarray(jX), jnp.asarray(jY), jnp.asarray(jsubs))
        ts, met = tstep(ts, *batch)
        steps += 1
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {steps}")
    assert steps == int(ts.step) == int(js.step) == 6
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    _assert_close_after_training(got, want, steps)


def test_god_spill_trajectory_matches_jax(god_setup):
    """8 GOD steps on host batches of the spilled packed set through the
    prefetch, against JAX's steps on its spilled set's numpy batches."""
    from meg_decoding_tpu_torch.data.packed import PackedDataset

    s = god_setup
    jstep, js, tstep, ts = _god_pair(s, {}, {"lr": LR, "epochs": 3,
                                             "lr_scheduler": "cosine"})
    jhost = s["jds"].to_host()
    assert jhost.host_resident
    thost = PackedDataset(
        X=torch.from_numpy(np.array(jhost.X)), Y=torch.from_numpy(np.array(jhost.Y)),
        subject_idxs=torch.from_numpy(np.array(jhost.subject_idxs)).long(),
        labels=torch.from_numpy(np.array(jhost.labels)).long(),
        num_subjects=2).to_host()
    rng = np.random.RandomState(21)
    draws = [rng.randint(0, len(thost), BATCH) for _ in range(8)]
    batches = prefetch_to_device((thost.gather(i)[:3] for i in draws),
                                 device="cpu")
    for i, (idx, batch) in enumerate(zip(draws, batches)):
        jX, jY, jsubs = jhost.gather(idx)[:3]
        js, jmet = jstep(js, jnp.asarray(jX), jnp.asarray(jY), jnp.asarray(jsubs))
        ts, met = tstep(ts, *batch)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
    assert int(ts.step) == int(js.step) == 8
    got, want = _state_dicts(js, ts)
    _assert_close_after_training(got, want, 8)


# --- the CLIs -------------------------------------------------------------------

def _rows(save_root):
    return _logged_epochs(save_root)[1]


def _same_rows(a, b):
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert ra.keys() == rb.keys()
        for k in ra:
            if not k.startswith("t_"):  # host times
                assert ra[k] == rb[k], (k, ra[k], rb[k])


def test_speech_trainer_spill_logs_the_device_run(train_setup, tmp_path, capsys):
    """``host_resident: true`` (sentence split, wandb asked for, the first
    epoch traced) against the device-resident unfused run: the same rows."""
    from meg_decoding_tpu_torch.cli.train_speech import run

    common = dict(epochs=2, split_mode="sentence", fuse_gather=False,
                  d_drop=0.1, run_name="r")
    run(_speech_cli_cfg(train_setup, tmp_path / "dev", **common), device="cpu")
    prof = tmp_path / "prof"
    host_cfg = _speech_cli_cfg(train_setup, tmp_path / "host", host_resident=True,
                               use_wandb=True, profile_dir=str(prof),
                               profile_epoch=0, **common)
    run(host_cfg, device="cpu")
    assert "falling back to JSONL only" in capsys.readouterr().out
    assert host_cfg.fuse_gather is False and host_cfg.use_scan_epochs is False
    _same_rows(_rows(str(tmp_path / "dev" / "out")),
               _rows(str(tmp_path / "host" / "out")))
    traces = os.listdir(prof)
    assert len(traces) == 1  # epoch 0 only
    with open(prof / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any("convolution" in str(n) for n in names)


def test_god_trainer_spill_logs_the_device_run(god_setup, tmp_path):
    from meg_decoding_tpu_torch.cli.train_god import run

    s = god_setup
    rows = {}
    for host in (False, True):
        cfg = Config(dict(to_dict(s["cfg"]), model="linear", F=16, scp=True,
                          batch_size=16, updates=4, epochs=2, use_sampler=True,
                          test_size=16, lr=LR, lr_scheduler="none",
                          training_mode="split", seed=0, run_name="r",
                          host_resident=host,
                          save_root=str(tmp_path / str(host))))
        run(cfg, device="cpu")
        rows[host] = _rows(cfg.save_root)
    _same_rows(rows[False], rows[True])


def test_profile_trace_writes_a_trace_and_none_does_nothing(tmp_path):
    from meg_decoding_tpu_torch.utils.profiling import profile_trace

    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "p")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (trace,) = os.listdir(tmp_path / "p")
    with open(tmp_path / "p" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" == e.get("name") for e in events)


def test_run_logger_falls_back_to_jsonl_without_wandb(tmp_path, capsys):
    from meg_decoding_tpu_torch.utils.logging import RunLogger

    logger = RunLogger(str(tmp_path), run_name="r", use_wandb=True,
                       wandb_cfg=Config({"project": "p", "entity": None,
                                         "run_name": "r"}))
    assert "falling back to JSONL only" in capsys.readouterr().out
    logger.log({"epoch": 0, "train_loss": torch.tensor(1.5)})
    with open(logger.path) as f:
        assert json.loads(f.read()) == {"epoch": 0, "train_loss": 1.5}
