"""The port's Brennan2018 slice against the JAX package, on the CPU: the
synthetic raw files and their loader, the easycap layout, the dataset
build, the long-row percentiles and the quantile kernel's long-row walk,
the packed gather, the unfused train step (Brennan, and Gwilliams with
``fuse_gather: false`` against the fused step) and both speech CLIs on
Brennan.

Both sides take the same inputs, made with numpy from a seed; the random
draws (subjects, batch order) are handed to both.  The encoders run with
``d_drop = 0``.

Tolerances, each with its reason:
* the synthetic files, the loaded EEG, the layouts, the packed gather and
  subset — exactly equal (the same numpy/scipy code, or plain indexing);
* the built dataset — X within 5e-6·max|X| (the bandpass and the resample
  are f32 FFTs of another length and order: overlap-save with power-of-two
  blocks and Bluestein in JAX, one FFT at a fast length here; the robust
  scale carries that relative error), Y exactly equal;
* the plain percentiles against JAX's sort path on rows past the kernel's
  shared-memory limit — ≤ 2 ulp (XLA may contract JAX's blend into an
  FMA, ROADMAP Queue 3); the long-row walk's order statistics exactly
  those of a sort;
* the Brennan train trajectory — loss rtol 1e-3 at every step, the first
  step's gradient norm rtol 1e-4, the state as the speech trajectory test
  holds it (``tests/test_torch_port_train_slice.py``);
* the unfused Gwilliams step and train CLI against the fused ones on the
  same draws — exactly equal (the same gather and step on the CPU);
* the Brennan eval CLI against JAX's on one checkpoint, split and subject
  draw — top-k equal, the pairwise score within 1e-6.  The Brennan train
  CLI is run end to end (finite metrics, a checkpoint the eval CLI reads);
  its draws come from torch generators, JAX's from its keys, so its
  epoch is not compared with JAX's; the build, the packed gather and the
  step it runs are held above.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.io
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import params_from_jax
from meg_decoding_tpu_torch.ops.kernels import quantile as tq
from tests.test_torch_port_kernel_designs import _const, _flip
from tests.test_torch_port_kernels import _hard_rows, _ulp_diff
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _logged_epochs,
    train_setup,  # noqa: F401
)
from tests.test_torch_port_train_slice import _cli_cfg as _speech_cli_cfg

D1, D2, K, NB, BATCH, LR, TEMP0 = 16, 24, 4, 2, 16, 1e-3, 5.1
C, F, N_SUBJECTS, REC_SEC = 12, 16, 3, 60.0
DATASET_RTOL = 5e-6
assert LR == 1e-3  # the walk of _assert_close_after_training


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_raw(path, eeg, fs):
    """One fieldtrip-style ``raw`` struct, as the generator writes it."""
    entry = np.zeros((1,), dtype=[("trial", "O"), ("fsample", "O"),
                                  ("label", "O")])
    trial = np.zeros((1, 1), dtype=object)
    trial[0, 0] = eeg
    entry[0]["trial"] = trial
    entry[0]["fsample"] = np.array([[fs]])
    entry[0]["label"] = np.array([["ch"]])
    scipy.io.savemat(path, {"raw": entry.reshape(1, 1)})


@pytest.fixture(scope="module")
def brennan(tmp_path_factory):
    """Three subjects × 12 channels × 60 s at 500 Hz and a 16-wide stream,
    from the port's generator; plus an excluded subject (S07) and a fourth
    usable one (S10) whose recording is 2 s longer (trimmed away)."""
    from meg_decoding_tpu_torch.data.brennan import load_brennan_eeg
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_brennan_raw

    root = str(tmp_path_factory.mktemp("brennan"))
    cfg = make_synthetic_brennan_raw(root, n_subjects=N_SUBJECTS, C=C,
                                     rec_sec=REC_SEC, F=F, seed=3)
    raw = os.path.join(root, "data", "Brennan2018", "raw")
    rng = np.random.RandomState(4)
    T = int(500 * REC_SEC)
    _write_raw(os.path.join(raw, "S07.mat"), rng.randn(C, T), 500.0)
    _write_raw(os.path.join(raw, "S10.mat"), rng.randn(C, T + 1000), 500.0)
    X, fs = load_brennan_eeg(raw)
    Y = np.load(os.path.join(root, "data", "Brennan2018", "Y_embeds",
                             "embd_wav2vec.npy"))
    return dict(root=root, cfg=cfg, X=X, fs=fs, Y=Y)


def _jcfg(cfg, **pre):
    c = JConfig(to_dict(cfg))
    for k, v in pre.items():
        c.preprocs[k] = v
    return c


# --- data -------------------------------------------------------------------

def test_synthetic_brennan_files_match_jax(tmp_path):
    from meg_decoding_tpu.data.synthetic import make_synthetic_brennan_raw as jmake
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_brennan_raw

    jcfg = jmake(str(tmp_path / "j"), n_subjects=2, C=6, rec_sec=20.0, F=8,
                 seed=5)
    tcfg = make_synthetic_brennan_raw(str(tmp_path / "t"), n_subjects=2, C=6,
                                      rec_sec=20.0, F=8, seed=5)
    assert {**to_dict(tcfg), "root_dir": None} == {**to_dict(jcfg), "root_dir": None}
    sub = os.path.join("data", "Brennan2018")
    names = sorted(os.listdir(tmp_path / "j" / sub / "raw"))
    assert names == sorted(os.listdir(tmp_path / "t" / sub / "raw")) \
        == ["S01.mat", "S03.mat"]
    for n in names:
        j = scipy.io.loadmat(tmp_path / "j" / sub / "raw" / n)["raw"][0, 0]
        t = scipy.io.loadmat(tmp_path / "t" / sub / "raw" / n)["raw"][0, 0]
        np.testing.assert_array_equal(t["trial"][0, 0], j["trial"][0, 0])
        np.testing.assert_array_equal(t["fsample"], j["fsample"])
        np.testing.assert_array_equal(t["label"], j["label"])
    np.testing.assert_array_equal(
        np.load(tmp_path / "t" / sub / "Y_embeds" / "embd_wav2vec.npy"),
        np.load(tmp_path / "j" / sub / "Y_embeds" / "embd_wav2vec.npy"))


def test_load_brennan_eeg_matches_jax(brennan):
    from meg_decoding_tpu.data.brennan import EXCLUDED_SUBJECTS as JEX
    from meg_decoding_tpu.data.brennan import load_brennan_eeg as jload
    from meg_decoding_tpu_torch.data.brennan import EXCLUDED_SUBJECTS

    assert EXCLUDED_SUBJECTS == JEX
    raw = os.path.join(brennan["root"], "data", "Brennan2018", "raw")
    jX, jfs = jload(raw)
    # S01, S03, S04 and S10 (trimmed to 60 s); S07 excluded
    assert brennan["X"].shape == jX.shape == (4, C, int(500 * REC_SEC))
    np.testing.assert_array_equal(brennan["X"], jX)
    assert brennan["fs"] == jfs == 500.0


@pytest.mark.parametrize("num_channels", [60, 61, 12])
def test_brennan_layout_matches_jax(num_channels):
    from meg_decoding_tpu.data.layout import ch_locations_2d as jloc
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d

    cfg = {"dataset": "Brennan2018", "num_channels": num_channels}
    if num_channels in (60, 61):
        got, want = ch_locations_2d(Config(cfg)), jloc(JConfig(cfg))
    else:
        with pytest.warns(UserWarning, match="synthetic cap"):
            got = ch_locations_2d(Config(cfg))
        with pytest.warns(UserWarning, match="synthetic cap"):
            want = jloc(JConfig(cfg))
    assert got.shape == (num_channels, 2)
    np.testing.assert_array_equal(got, want)


def _builds(brennan, faithful_split=False, **pre):
    from meg_decoding_tpu.data.brennan import build_brennan_dataset as jbuild
    from meg_decoding_tpu_torch.data.brennan import build_brennan_dataset

    X, Y, fs = brennan["X"][:N_SUBJECTS], brennan["Y"], brennan["fs"]
    jcfg = _jcfg(brennan["cfg"], **pre)
    j = jbuild(jcfg, Y, X, fs, faithful_split=faithful_split)
    t = build_brennan_dataset(Config(to_dict(jcfg)), Y, X, fs,
                              faithful_split=faithful_split, device="cpu")
    return j, t


@pytest.mark.parametrize("subject_wise", [True, False])
@pytest.mark.parametrize("faithful_split", [False, True])
@pytest.mark.parametrize("shift_brain", [True, False])
def test_build_brennan_dataset_matches_jax(brennan, subject_wise,
                                           faithful_split, shift_brain):
    j, t = _builds(brennan, faithful_split, subject_wise=subject_wise,
                   shift_brain=shift_brain)
    jX, jY = np.asarray(j.X), np.asarray(j.Y)
    assert tuple(t.X.shape) == jX.shape and tuple(t.Y.shape) == jY.shape
    assert t.num_subjects == j.num_subjects == N_SUBJECTS
    err = np.abs(t.X.numpy() - jX).max() / np.abs(jX).max()
    assert err <= DATASET_RTOL, err
    np.testing.assert_array_equal(t.Y.numpy(), jY)


def test_brennan_packed_gather_and_subset_match_jax(brennan):
    from meg_decoding_tpu.data.brennan import BrennanPacked as JPacked
    from meg_decoding_tpu_torch.data.brennan import BrennanPacked

    rng = np.random.RandomState(6)
    Xc = rng.randn(10, N_SUBJECTS, C, 40).astype(np.float32)
    Yc = rng.randn(10, F, 40).astype(np.float32)
    j, t = JPacked(jnp.asarray(Xc), jnp.asarray(Yc)), \
        BrennanPacked(torch.from_numpy(Xc), torch.from_numpy(Yc))
    idx, subs = np.array([3, 0, 9, 3]), np.array([2, 0, 1, 1])
    for got, want in zip(t.gather(idx, subject_idxs=subs),
                         j.gather(idx, subject_idxs=subs)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    keep = np.array([7, 2, 5])
    ts, js = t.subset(keep), j.subset(keep)
    assert len(ts) == len(js) == 3 and ts.num_subjects == N_SUBJECTS
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    np.testing.assert_array_equal(ts.Y.numpy(), np.asarray(js.Y))
    # a drawn subject comes from the generator alone
    a = t.gather(idx, generator=torch.Generator().manual_seed(1))
    b = t.gather(idx, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a[2], b[2]) and int(a[2].max()) < N_SUBJECTS
    with pytest.raises(ValueError, match="Generator"):
        t.gather(idx)


# --- the long rows of robust_quantiles ----------------------------------------

@pytest.mark.parametrize("shape", [(4, 60_000), (2, 3 * 40_000)])
def test_plain_long_row_percentiles_match_jax_sort(shape):
    """Rows past the shared-memory limit: a subject's channel, and the
    pooled layout of the build, (C, S·T) from (S, C, T)."""
    from meg_decoding_tpu.ops.scaling import robust_stats as jstats
    from meg_decoding_tpu_torch.ops.scaling import robust_stats

    assert shape[1] > tq.SHARED_MAX_T
    rng = np.random.RandomState(shape[0])
    if shape[0] == 2:  # (S=3, C=2, T) pooled as the build pools it
        x = rng.randn(3, 2, shape[1] // 3).astype(np.float32)
        x = np.ascontiguousarray(x.transpose(1, 0, 2).reshape(2, -1))
    else:
        x = (rng.randn(*shape) * 3.0).astype(np.float32)
        x[1] = np.round(x[1])  # many ties
    med, iqr = robust_stats(torch.from_numpy(x))
    jmed, jiqr = jstats(jnp.asarray(x))
    assert _ulp_diff(med.numpy(), np.asarray(jmed)) <= 2
    assert _ulp_diff(iqr.numpy(), np.asarray(jiqr)) <= 2


def test_kernel_route_takes_the_global_path_past_the_shared_limit():
    src = "robust_quantiles"
    assert tq.SHARED_MAX_T == _const("kSharedMaxT", src) == 58_112
    for T, route in ((1, "register"), (tq.REGISTER_MAX_T, "register"),
                     (tq.REGISTER_MAX_T + 1, "shared"),
                     (tq.SHARED_MAX_T, "shared"),
                     (tq.SHARED_MAX_T + 1, "global"), (89_000, "global"),
                     (33 * 89_000, "global"), (2**31 - 1, "global")):
        assert tq.kernel_route(T) == route, T


def _long_walk(x: np.ndarray, qs=(25.0, 50.0, 75.0)):
    """The global-memory path as ``csrc/robust_quantiles.cu`` runs it: per
    pass, every CTA's histogram of the next 8-bit digit for each distinct
    target prefix, summed over the row's CTAs of ``kLongChunk`` keys; then
    each target's digit and remaining rank.  Returns the targets' keys
    (N, 2n) (unsigned) and their ranks."""
    src = "robust_quantiles"
    chunk, bins = _const("kLongChunk", src), _const("kBins", src)
    N, T = x.shape
    u = (_flip(x.view(np.int32)).view(np.uint32) ^ np.uint32(0x80000000))
    ranks = []
    for rank, _, _, interp in tq.ranks_and_weights(T, qs):
        ranks += [rank, rank + 1 if interp else rank]
    keys = np.zeros((N, len(ranks)), np.uint32)
    for row in range(N):
        prefix, remain = [0] * len(ranks), list(ranks)
        for p in range(4):
            shift = 24 - 8 * p
            mask = 0 if p == 0 else (0xFFFFFFFF << (32 - 8 * p)) & 0xFFFFFFFF
            owner = [prefix.index(prefix[t]) for t in range(len(ranks))]
            hist = np.zeros((len(ranks), bins), np.int64)
            for c in range(-(-T // chunk)):
                seg = u[row, c * chunk:(c + 1) * chunk].astype(np.int64)
                digit = (seg >> shift) & (bins - 1)
                for t in set(owner):
                    hit = (seg & mask) == prefix[t]
                    hist[t] += np.bincount(digit[hit], minlength=bins)
            for t in range(len(ranks)):
                cum = np.cumsum(hist[owner[t]])
                d = int(np.searchsorted(cum, remain[t], side="right"))
                remain[t] -= int(cum[d - 1]) if d else 0
                prefix[t] |= d << shift
        keys[row] = prefix
    return keys, ranks


def test_long_row_walk_finds_the_exact_order_statistics():
    """At T = 58,113 (just past the shared-memory path) on rows with NaN
    of both signs, ±inf, ±0, constants and ties, and one row whose order
    statistics all fall in one run of equal values."""
    T = tq.SHARED_MAX_T + 1
    x = _hard_rows(T, np.random.RandomState(7))[:12]
    lo, hi = T // 5, T - T // 5
    x[9, :lo] = -1.0 - np.abs(x[9, :lo])
    x[9, lo:hi] = 0.5
    x[9, hi:] = 2.0 + np.abs(x[9, hi:])
    keys, ranks = _long_walk(x)
    srt = np.sort(_flip(x.view(np.int32)).view(np.uint32)
                  ^ np.uint32(0x80000000), axis=1)
    np.testing.assert_array_equal(keys, srt[:, ranks])
    # the blend of those statistics is the plain version's
    vals = _flip((keys ^ np.uint32(0x80000000)).view(np.int32)).view(np.float32)
    plain = tq.robust_quantiles_plain(torch.from_numpy(x)).numpy()
    for q, (_, w_lo, w_hi, interp) in enumerate(tq.ranks_and_weights(T, (25, 50, 75))):
        v_lo, v_hi = vals[:, 2 * q], vals[:, 2 * q + 1]
        with np.errstate(invalid="ignore"):
            want = ((v_lo.astype(np.float64) * w_lo
                     + (v_hi * np.float32(w_hi)).astype(np.float64))
                    .astype(np.float32) if interp else v_lo)
        assert _ulp_diff(plain[:, q], want) == 0, q
    np.testing.assert_array_equal(plain[9], np.float32(0.5))


# --- the unfused train step -----------------------------------------------

def test_brennan_train_trajectory_matches_jax(brennan, monkeypatch):
    """6 unfused steps on Brennan batches (random chunks and subjects,
    handed to both) with the collate off, from one converted init; the
    collate must not run at all."""
    import meg_decoding_tpu_torch.train.steps as tsteps
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_train_step as jmake
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import (
        CollateConfig,
        LossConfig,
        make_train_step,
    )

    def no_collate(*a, **k):
        raise AssertionError("the collate ran with enabled=False")

    monkeypatch.setattr(tsteps, "collate_preprocess", no_collate)
    monkeypatch.setattr(tsteps, "collate_preprocess_cached", no_collate)
    _, t = _builds(brennan)
    Xc, Yc = t.X.numpy(), t.Y.numpy()
    with pytest.warns(UserWarning, match="synthetic cap"):
        loc = ch_locations_2d(brennan["cfg"])
    sched = {"lr": LR, "epochs": 3, "lr_scheduler": "cosine"}
    jm = JEnc(loc=loc, num_subjects=N_SUBJECTS, D1=D1, D2=D2, F=F, K=K,
              d_drop=0.0, seq2seq=True, num_blocks=NB)
    jo = jopt(JConfig(sched), 2)
    example = (jnp.asarray(Xc[:4, 0]), jnp.asarray(Yc[:4]),
               jnp.zeros(4, jnp.int32))
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    jstep = jmake(jm, jo, JLoss(grad_norms=True), JCollate(enabled=False))
    tm = TEnc(loc, N_SUBJECTS, D1=D1, D2=D2, F=F, K=K, d_drop=0.0,
              seq2seq=True, num_blocks=NB, device="cpu")
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    with torch.no_grad():
        tm.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith("loss.")})
    to = make_optimizer(Config(sched), 2)
    ts = create_train_state(tm, to, init_temperature=TEMP0, seed=0)
    tstep = make_train_step(tm, to, LossConfig(grad_norms=True),
                            CollateConfig(enabled=False))
    rng = np.random.RandomState(8)
    steps = 6
    for i in range(steps):
        idx = rng.randint(0, len(t), BATCH)
        subs = rng.randint(0, N_SUBJECTS, BATCH)
        X, Y = Xc[idx, subs], Yc[idx]
        js, jmet = jstep(js, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(subs))
        ts, met = tstep(ts, torch.from_numpy(X), torch.from_numpy(Y),
                        torch.from_numpy(subs))
        assert float(met["skipped"]) == float(jmet["skipped"]) == 0.0
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-3, err_msg=f"step {i + 1}")
        if i == 0:
            np.testing.assert_allclose(float(met["grad_norm"]),
                                       float(jmet["grad_norm"]), rtol=1e-4)
    assert int(ts.step) == int(js.step) == steps
    want = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    got = {**ts.model.state_dict(), "loss.temp": ts.temp.detach()}
    _assert_close_after_training(got, want, steps)


def test_unfused_gwilliams_step_equals_the_fused_step(train_setup):
    """The pool's gather + ``make_train_step`` against the fused step, 3
    steps on the same segments and session draws (one generator seed a
    step on each side)."""
    from meg_decoding_tpu_torch.cli.evaluate_speech import SpeechPool
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_train_step
    from tests.test_torch_port_train_slice import _collate_cfgs

    s = train_setup
    collate = _collate_cfgs(s["cfg"])[1]

    def fresh():
        model = BrainEncoder(s["loc"], 3, D1=D1, D2=D2, F=16, K=K,
                             seq2seq=True, num_blocks=NB, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(Config({"lr": LR, "epochs": 1}), 3)
        return model, opt, create_train_state(model, opt, TEMP0, seed=0)

    fm, fo, fs = fresh()
    um, uo, us = fresh()
    fused = make_fused_speech_step(fm, fo, LossConfig(), collate, s["t_tr"])
    unfused = make_train_step(um, uo, LossConfig(), collate)
    pool = SpeechPool(s["t_tr"])
    rng = np.random.RandomState(9)
    for i in range(3):
        idx = rng.randint(0, len(pool), BATCH)
        fs, fmet = fused(fs, pool.segment_ids(idx),
                         generator=torch.Generator().manual_seed(i))
        us, umet = unfused(us, *pool.gather(
            idx, generator=torch.Generator().manual_seed(i)))
        for k in fmet:
            assert torch.equal(umet[k], fmet[k]), (i, k)
    for k, v in fm.state_dict().items():
        assert torch.equal(um.state_dict()[k], v), k


# --- the CLIs ---------------------------------------------------------------

def test_train_cli_unfused_gwilliams_equals_fused(train_setup, tmp_path):
    """``fuse_gather=false`` through ``fit``: the same epoch, metrics and
    checkpoint as the fused step (the per-step generators are the same)."""
    from meg_decoding_tpu_torch.cli.train_speech import run

    rows, states = {}, {}
    for fuse in (True, False):
        cfg = _speech_cli_cfg(train_setup, tmp_path / str(fuse), epochs=1,
                              fuse_gather=fuse, run_name="r")
        run(cfg, device="cpu")
        rows[fuse] = _logged_epochs(cfg.save_root)[1][0]
        states[fuse] = torch.load(os.path.join(cfg.save_root, "ckpt",
                                               "model_last.pt"),
                                  weights_only=True)["params"]
    for k, v in rows[True].items():
        if not k.startswith("t_"):  # host times
            assert rows[False][k] == v, k
    for k, v in states[True].items():
        assert torch.equal(states[False][k], v), k


def _brennan_cli_args(root, out, *extra):
    return ["--device", "cpu", "dataset=Brennan2018", f"root_dir={root}",
            f"save_root={out}", "epochs=1", "updates=3", f"D1={D1}",
            f"D2={D2}", f"K={K}", f"F={F}", "preprocs.last4layers=false",
            "batch_size=8", "run_name=b", *extra]


def test_brennan_clis_train_and_evaluate_end_to_end(brennan, tmp_path):
    """The train CLI for one epoch of 3 updates on the synthetic files,
    subjects pooled for the robust scale; then the eval CLI on its
    checkpoint.  Only the usable subjects with the generator's length."""
    from meg_decoding_tpu_torch.cli import evaluate_speech, train_speech

    root = str(tmp_path / "root")
    shutil.copytree(brennan["root"], root)
    for n in ("S07.mat", "S10.mat"):
        os.remove(os.path.join(root, "data", "Brennan2018", "raw", n))
    out = str(tmp_path / "out")
    args = _brennan_cli_args(root, out, "preprocs.subject_wise=false")
    with pytest.warns(UserWarning, match="synthetic cap"):
        best = train_speech.main(args)
    assert best["epoch"] == 0 and best["train_skipped"] == 0.0
    for k in ("train_loss", "test_loss"):
        assert np.isfinite(best[k])
    assert os.path.exists(os.path.join(out, "ckpt", "model_last.pt"))
    with pytest.warns(UserWarning, match="synthetic cap"):
        res = evaluate_speech.main(args)
    assert 0.0 <= res["test_top1"] <= res["test_top10"] <= 1.0
    assert np.isfinite(res["pairwise_correlation"])
    # 19 chunks of 3 s, 80 % to training: 4 test chunks in one pool
    assert res["n_test_segments"] == 4 and res["n_pools"] == 1


def _subject_by_chunk(monkeypatch, cls):
    """Hand a Brennan dataset's gather the subject ``chunk % S`` in place
    of its random draw, so that both packages score the same pairs."""
    gather = cls.gather
    monkeypatch.setattr(
        cls, "gather", lambda self, idx, subject_idxs=None, **_: gather(
            self, idx, subject_idxs=np.asarray(idx) % self.num_subjects))


def test_brennan_eval_cli_matches_jax(brennan, tmp_path, monkeypatch):
    """Both eval CLIs on the same Brennan files, from one JAX init: JAX
    restores its own checkpoint, the port reads the same weights converted
    (``params_from_jax``).  Both take the same test split (15 of 19 chunks,
    two pools of 12) and the same subject a chunk.  The pools, top-1 and
    top-10 are equal (the embeddings differ by the build's f32 FFT
    numerics, too little to reorder a pool's similarities); the pairwise
    score within 1e-6 (the same ranks, averaged in f32 in another
    order)."""
    import meg_decoding_tpu.cli.train_speech as jtrain
    import meg_decoding_tpu.data.brennan as jbrennan
    import meg_decoding_tpu_torch.cli.evaluate_speech as tevaluate
    import meg_decoding_tpu_torch.data.brennan as tbrennan
    from meg_decoding_tpu.cli.evaluate_speech import run as jrun
    from meg_decoding_tpu.core.config import compose as jcompose
    from meg_decoding_tpu.data.layout import ch_locations_2d as jloc
    from meg_decoding_tpu.models.factory import get_model as jget_model
    from meg_decoding_tpu.train.checkpoint import CheckpointManager as JCkpt
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate

    def split(_, n, ratio):
        perm = np.random.RandomState(5).permutation(n)
        return perm[:int(round(n * ratio))], perm[int(round(n * ratio)):]

    monkeypatch.setattr(jtrain, "random_split", split)
    monkeypatch.setattr(tevaluate, "random_split", split)
    _subject_by_chunk(monkeypatch, jbrennan.BrennanPacked)
    _subject_by_chunk(monkeypatch, tbrennan.BrennanPacked)

    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    keys = _brennan_cli_args(brennan["root"], "OUT", "split_ratio=0.2",
                             "test_size=12", "d_drop=0")[2:]
    jcfg = jcompose("configs", "config",
                    [k for k in keys if not k.startswith("save_root")]
                    + [f"save_root={out_j}"])
    jcfg.num_subjects = S = brennan["X"].shape[0]
    jcfg.num_channels = C
    with pytest.warns(UserWarning, match="synthetic cap"):
        jm = jget_model(jcfg, loc=jloc(jcfg), num_channels=C)
    # running statistics fitted to Brennan chunks: at the init's (mean 0,
    # var 1) the eval-mode encoder all but ignores its input, and every
    # pool would rank its candidates by the output's constant part alone
    built = tbrennan.build_brennan_dataset(
        Config(to_dict(brennan["cfg"])), brennan["Y"], brennan["X"],
        brennan["fs"], device="cpu")
    X = jnp.asarray(built.X[:8].numpy()[np.arange(8), np.arange(8) % S])
    subs = jnp.arange(8) % S
    js = jstate(jm, jopt(jcfg, int(jcfg.updates)),
                (X, jnp.asarray(built.Y[:8].numpy()), subs),
                jax.random.PRNGKey(123))
    fit_stats = jax.jit(lambda bs: jm.apply(
        {"params": js.params["model"], "batch_stats": bs}, X, subs,
        train=True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(0),
              "spatial": jax.random.PRNGKey(1)})[1]["batch_stats"])
    bs = js.batch_stats
    for _ in range(100):
        bs = fit_stats(bs)
    js = js.replace(batch_stats=bs)
    JCkpt(os.path.join(out_j, "ckpt")).save("model_best", js)
    os.makedirs(os.path.join(out_t, "ckpt"))
    torch.save(params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats})),
        os.path.join(out_t, "ckpt", "model.pt"))

    with pytest.warns(UserWarning, match="synthetic cap"):
        want = jrun(jcfg)
    with pytest.warns(UserWarning, match="synthetic cap"):
        got = tevaluate.main(_brennan_cli_args(brennan["root"], out_t,
                                               "split_ratio=0.2", "test_size=12",
                                               "d_drop=0"))
    assert (got["n_test_segments"], got["pool_size"], got["n_pools"]) \
        == (want["n_test_segments"], want["pool_size"], want["n_pools"]) \
        == (15, 12, 2)
    for k in ("test_top1", "test_top10"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["pairwise_correlation"],
                               want["pairwise_correlation"], rtol=0, atol=1e-6)
