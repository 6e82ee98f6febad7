"""The port's GOD data build against the JAX package and float64 references,
on the CPU: ROI and montage, the FIR design and application, FFT
resampling, the epoch gather, the host loaders and the packed train / val
datasets on ``make_synthetic_god_dataset`` fixtures.

Tolerances, each with its reason:
* ROI channels, sensor positions, FIR taps, the CV split, host loaders and
  everything the host computes in numpy (labels, features, subjects) —
  exact: the same numpy/scipy code on the same files;
* ``epoch_slice`` — bit-exact: a gather moves values, it computes none;
* ``apply_fir``, ``bandpass_filter``, ``resample_fft``, ``rfft_any`` — in
  f32, max |Δ| ≤ 2e-6·max|reference| against the JAX package and against
  float64 numpy/scipy: the port transforms at native lengths (one FFT
  convolution), the JAX package in power-of-two overlap-save blocks and
  Bluestein transforms, so the two round differently; both sit ~1e-7–5e-7
  of the signal's peak from the float64 result;
* the built epochs (X) and their normalization statistics — max |Δ| ≤
  5e-6·max|JAX| for the same reason, carried through the filter, the
  resample and the per-unit z-scoring.
"""

import json
import os
import shutil

import numpy as np
import pytest
import scipy.io
import scipy.signal
import torch

import jax.numpy as jnp

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict

SIGNAL_RTOL = 2e-6
DATASET_RTOL = 5e-6


def _close_to_peak(got, want, rtol, what=""):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"{what}: max|Δ|/max|ref| = {err}"


@pytest.fixture(scope="module")
def god(tmp_path_factory):
    """Two subjects × (40 train, 10 val) trials, 12 channels at 200 Hz, an
    8-channel ROI; written by the port's generator."""
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    root = str(tmp_path_factory.mktemp("god_data"))
    return make_synthetic_god_dataset(root, subjects=("sbj01", "sbj02"),
                                      n_train=40, n_test=10)


def _cfgs(cfg, **kw):
    d = dict(to_dict(cfg), **kw)
    return JConfig(d), Config(d)


# --- ROI, montage, CV split, synthetic writer -------------------------------

def test_roi_and_god_layout_match_jax(god):
    from meg_decoding_tpu.data.layout import ch_locations_2d as jloc
    from meg_decoding_tpu.data.roi import roi as jroi
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.data.roi import roi

    # the packaged region table and montage (no paths in the config)
    packaged = {"dataset": "GOD", "region": ["occipital/left", "occipital/right"]}
    jc, tc = JConfig(packaged), Config(packaged)
    chans = roi(tc)
    assert chans == jroi(jc)
    assert chans == list(range(128, 139)) + list(range(144, 155))
    np.testing.assert_array_equal(ch_locations_2d(tc), jloc(jc))
    assert ch_locations_2d(tc).shape == (22, 2)
    assert roi(tc, region=["occipital/left"]) == list(range(128, 139))
    # the fixture's own table and montage, and an explicit CSV with an ROI
    jc, tc = _cfgs(god)
    assert roi(tc) == jroi(jc) == list(range(8))
    np.testing.assert_array_equal(ch_locations_2d(tc, roi(tc)),
                                  jloc(jc, jroi(jc)))
    jc, tc = _cfgs(god, layout_csv=god.montage_path)
    np.testing.assert_array_equal(ch_locations_2d(tc, [1, 3, 5]),
                                  jloc(jc, [1, 3, 5]))
    with pytest.raises(ValueError, match="region/subregion"):
        roi(tc, region=["occipital"])


def test_god_cv_split_matches_jax():
    from meg_decoding_tpu.data.sampling import god_cv_split as jsplit
    from meg_decoding_tpu_torch.data.sampling import god_cv_split

    for args in ((), (600, 1, 500), (40, 2, 33)):
        for a, b in zip(god_cv_split(*args), jsplit(*args)):
            np.testing.assert_array_equal(a, b)


def test_synthetic_god_writer_matches_jax(tmp_path):
    from meg_decoding_tpu.data.synthetic import make_synthetic_god_dataset as jmake
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    kw = dict(num_channels=6, num_roi=4, fs=100.0, n_train=5, n_test=3,
              feat_dim=4, subjects=("s1",), seed=3)
    a = make_synthetic_god_dataset(str(tmp_path / "port"), **kw)
    b = jmake(str(tmp_path / "jax"), **kw)
    assert {k: v for k, v in to_dict(a).items() if k not in
            ("data_root", "ch_region_path", "montage_path")} == \
        {k: v for k, v in to_dict(b).items() if k not in
         ("data_root", "ch_region_path", "montage_path")}
    for rel in ("s1/mat/train.mat", "s1/labels/val.mat", "s1/trigger/train.mat"):
        ma = scipy.io.loadmat(os.path.join(a.data_root, rel))
        mb = scipy.io.loadmat(os.path.join(b.data_root, rel))
        for k in ("F", "vec_image", "vec_index", "trigger"):
            if k in mb:
                np.testing.assert_array_equal(ma[k], mb[k], err_msg=f"{rel} {k}")
    np.testing.assert_array_equal(np.loadtxt(a.montage_path, delimiter=","),
                                  np.loadtxt(b.montage_path, delimiter=","))
    with open(a.ch_region_path) as fa, open(b.ch_region_path) as fb:
        assert json.load(fa) == json.load(fb)
    # float32 storage holds the same draws, rounded once
    c = make_synthetic_god_dataset(str(tmp_path / "f32"), meg_dtype=np.float32, **kw)
    F32 = scipy.io.loadmat(os.path.join(c.data_root, "s1/mat/train.mat"))["F"]
    F64 = scipy.io.loadmat(os.path.join(b.data_root, "s1/mat/train.mat"))["F"]
    assert F32.dtype == np.float32
    np.testing.assert_array_equal(F32, F64.astype(np.float32))


# --- DSP -------------------------------------------------------------------

@pytest.mark.parametrize("sfreq,l_freq,h_freq,n_taps", [
    (1000.0, 2.0, 5.0, 1651),     # GOD: ceil(3.3 / 2 · 1000) = 1650, made odd
    (200.0, 1.0, 40.0, 661),      # the fixture's band
    (1000.0, 1.0, 60.0, 3301),    # the reference's filter_data(1, 60)
    (500.0, 1.0, None, 1651),     # high-pass
    (500.0, None, 40.0, 165),     # low-pass
])
def test_design_bandpass_fir_taps_match_jax(sfreq, l_freq, h_freq, n_taps):
    from meg_decoding_tpu.ops.fir import design_bandpass_fir as jdesign
    from meg_decoding_tpu_torch.ops.fir import design_bandpass_fir

    h = design_bandpass_fir(sfreq, l_freq, h_freq)
    assert h.shape == (n_taps,) and h.dtype == np.float64
    np.testing.assert_array_equal(h, jdesign(sfreq, l_freq, h_freq))
    np.testing.assert_allclose(h, h[::-1], rtol=0, atol=1e-15)  # zero phase


def _reflect_limited_conv(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """float64 reference: MNE's reflect-limited pad, np.convolve, the
    zero-phase slice."""
    L, T = len(h), x.shape[-1]
    n_edge = (L - 1) // 2
    n_pad = min(n_edge, T - 1)
    left = 2 * x[..., :1] - x[..., 1:n_pad + 1][..., ::-1]
    right = 2 * x[..., -1:] - x[..., T - n_pad - 1:-1][..., ::-1]
    xp = np.concatenate([left, x, right], -1)
    rows = [np.convolve(r, h) for r in xp.reshape(-1, xp.shape[-1])]
    y = np.stack(rows).reshape(*x.shape[:-1], -1)
    return y[..., n_pad + n_edge:n_pad + n_edge + T]


@pytest.mark.parametrize("sfreq,band,T", [
    (200.0, (1.0, 40.0), 50),       # shorter than the 661 taps: n_pad = T − 1
    (200.0, (1.0, 40.0), 661),      # one overlap-save block in JAX
    (1000.0, (2.0, 5.0), 6001),     # GOD's taps, odd length
    (200.0, (1.0, 40.0), 30000),    # several overlap-save blocks in JAX
])
def test_apply_fir_matches_jax_and_float64(sfreq, band, T):
    from meg_decoding_tpu.ops import fir as jf
    from meg_decoding_tpu_torch.ops import fir as tf

    h = tf.design_bandpass_fir(sfreq, *band)
    x = np.random.RandomState(T).randn(3, T).astype(np.float32)
    ref = _reflect_limited_conv(x.astype(np.float64), h)
    got = tf.apply_fir(torch.from_numpy(x), torch.tensor(h, dtype=torch.float32))
    assert got.dtype == torch.float32
    want = np.asarray(jf.apply_fir(jnp.asarray(x), jnp.asarray(h, jnp.float32)))
    _close_to_peak(got, ref, SIGNAL_RTOL, "port vs float64")
    _close_to_peak(want, ref, SIGNAL_RTOL, "JAX vs float64")
    _close_to_peak(got, want, SIGNAL_RTOL, "port vs JAX")
    # bandpass_filter designs and applies in one call
    bp = tf.bandpass_filter(torch.from_numpy(x), sfreq, *band)
    jbp = np.asarray(jf.bandpass_filter(jnp.asarray(x), sfreq, *band))
    _close_to_peak(bp, jbp, SIGNAL_RTOL, "bandpass_filter")


@pytest.mark.parametrize("T,up,down", [
    (1000, 1.0, 1000 / 120),   # GOD's 1000 Hz → 120 Hz, even output
    (1001, 1.0, 2.0),          # odd input, even output
    (999, 3.0, 1.0),           # up-sampling, odd lengths
    (1200, 2.0, 1.0),          # up-sampling, even: the Nyquist halved
    (1024, 1.0, 4.0),          # powers of two (JAX's plain FFT path)
    (15100, 1.0, 1000 / 120),  # long rows, odd output
])
def test_resample_fft_matches_jax_and_scipy(T, up, down):
    from meg_decoding_tpu.ops import resample as jr
    from meg_decoding_tpu_torch.ops import resample as tr

    x = np.random.RandomState(T).randn(2, 3, T).astype(np.float32)
    n = tr.resample_len(T, up, down)
    assert n == jr.resample_len(T, up, down)
    ref = scipy.signal.resample(x.astype(np.float64), n, axis=-1)
    got = tr.resample_fft(torch.from_numpy(x), up=up, down=down)
    assert got.shape == (2, 3, n) and got.dtype == torch.float32
    want = np.asarray(jr.resample_fft(jnp.asarray(x), up=up, down=down))
    _close_to_peak(got, ref, SIGNAL_RTOL, "port vs scipy")
    _close_to_peak(want, ref, SIGNAL_RTOL, "JAX vs scipy")
    _close_to_peak(got, want, SIGNAL_RTOL, "port vs JAX")


def test_resample_len_of_a_god_recording():
    from meg_decoding_tpu_torch.ops.resample import resample_len

    assert resample_len(604000, down=1000 / 120) == 72480


@pytest.mark.parametrize("n", [16, 24, 25, 1000, 1001])
def test_fft_helpers_match_jax_and_numpy(n):
    from meg_decoding_tpu.ops import fft as jfft
    from meg_decoding_tpu_torch.ops import fft as tfft

    rng = np.random.RandomState(n)
    x = rng.randn(3, n).astype(np.float32)
    ref = np.fft.rfft(x.astype(np.float64))
    got = tfft.rfft_any(torch.from_numpy(x), n).numpy()
    _close_to_peak(got, ref, SIGNAL_RTOL, "rfft_any vs numpy")
    _close_to_peak(got, np.asarray(jfft.rfft_any(jnp.asarray(x), n)),
                   SIGNAL_RTOL, "rfft_any vs JAX")
    # a half-spectrum shorter than n // 2 + 1 is zero-padded (upsampling)
    half = ref[:, : n // 4 + 1].astype(np.complex64)
    for m in (n, 2 * n + 1):
        got = tfft.irfft_any(torch.from_numpy(half), m).numpy()
        _close_to_peak(got, np.fft.irfft(half.astype(np.complex128), m),
                       SIGNAL_RTOL, f"irfft_any({m}) vs numpy")
        _close_to_peak(got, np.asarray(jfft.irfft_any(jnp.asarray(half), m)),
                       SIGNAL_RTOL, f"irfft_any({m}) vs JAX")
    c = (x + 1j * rng.randn(3, n)).astype(np.complex64)
    for fn, np_fn in (("fft_any", np.fft.fft), ("ifft_any", np.fft.ifft)):
        got = getattr(tfft, fn)(torch.from_numpy(c), n).numpy()
        _close_to_peak(got, np_fn(c.astype(np.complex128)), SIGNAL_RTOL, fn)
        _close_to_peak(got, np.asarray(getattr(jfft, fn)(jnp.asarray(c), n)),
                       SIGNAL_RTOL, f"{fn} vs JAX")


# --- epoch gather --------------------------------------------------------------

@pytest.mark.parametrize("T,L", [(900, 24), (130, 20), (24, 24)])
def test_epoch_slice_is_bit_exact_with_jax(T, L):
    """Onsets inside, at the end, past the end (clamped left into range) and
    negative: the port equals the JAX package's CPU branch and its TPU branch
    (pre-clamp, pad to pad_time_for_gather, the Pallas gather in interpret
    mode)."""
    from meg_decoding_tpu.ops.pallas.window_gather import (
        pad_time_for_gather as jpad,
        window_gather as jgather,
    )
    from meg_decoding_tpu.ops.scaling import epoch_slice as jslice
    from meg_decoding_tpu_torch.ops.kernels import window_gather as twg
    from meg_decoding_tpu_torch.ops.scaling import epoch_slice

    x = np.random.RandomState(T).randn(5, T).astype(np.float32)
    onsets = np.array([0, 3, T - L, T - L + 1, T + 40, 10**6, -5, T // 3])
    before = twg.launches
    got = epoch_slice(torch.from_numpy(x), onsets, L)
    assert twg.launches == before  # the CPU runs the plain version
    assert got.shape == (len(onsets), 5, L)
    want = np.asarray(jslice(jnp.asarray(x), jnp.asarray(onsets), L))
    np.testing.assert_array_equal(got.numpy(), want)
    clamped = np.clip(onsets, 0, max(T - L, 0)).astype(np.int32)
    Tp = jpad(T, L)
    tpu = jgather(jnp.pad(jnp.asarray(x), ((0, 0), (0, Tp - T)))[None],
                  jnp.zeros(len(onsets), jnp.int32), jnp.asarray(clamped), L,
                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(tpu))
    # a window past the end is the last full window
    np.testing.assert_array_equal(got[4].numpy(), x[:, T - L:])


# --- host loaders -----------------------------------------------------------

def test_host_loaders_match_jax(god):
    from meg_decoding_tpu.data import god as jg
    from meg_decoding_tpu_torch.data import god as tg

    jc, tc = _cfgs(god)
    sub = os.path.join(god.data_root, "sbj01")
    mat = os.path.join(sub, "mat", "train.mat")
    mean, std = tg.get_baseline(mat, 200.0, 10)
    jmean, jstd = jg.get_baseline(mat, 200.0, 10)
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    args = (mat, os.path.join(sub, "labels", "train.mat"),
            os.path.join(sub, "trigger", "train.mat"), mean, std)
    got = tg.get_meg_data(*args, num_channels=12)
    want = jg.get_meg_data(*args, num_channels=12)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.float64
    np.testing.assert_array_equal(tg.time_window(tc, got[3], 100.0),
                                  jg.time_window(jc, want[3], 100.0))
    np.testing.assert_array_equal(
        tg.time_window(tc, got[3], 200.0, start=0.1, end=0.25),
        jg.time_window(jc, want[3], 200.0, start=0.1, end=0.25))
    with pytest.raises(ValueError, match="channels"):
        tg.get_meg_data(*args, num_channels=13)
    with pytest.raises(ValueError, match="600 trials"):
        tg.get_meg_data(*args, num_channels=12, enforce_split_sizes=True)


# --- the packed datasets --------------------------------------------------

def _assert_same_dataset(t, j, with_stats: bool):
    _close_to_peak(t.X.numpy(), np.asarray(j.X), DATASET_RTOL, "X")
    np.testing.assert_array_equal(t.Y.numpy(), np.asarray(j.Y))
    np.testing.assert_array_equal(t.subject_idxs.numpy(), np.asarray(j.subject_idxs))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    assert t.num_subjects == j.num_subjects
    assert t.X.dtype == torch.float32 and t.labels.dtype == torch.int64
    if with_stats:
        _close_to_peak(t.mean_X, j.mean_X, DATASET_RTOL, "mean_X")
        _close_to_peak(t.std_X, j.std_X, DATASET_RTOL, "std_X")
        np.testing.assert_array_equal(t.mean_Y, j.mean_Y)
        np.testing.assert_array_equal(t.std_Y, j.std_Y)


@pytest.mark.parametrize("variant", ["plain", "normalized", "manual_ch", "onsets"])
def test_build_god_dataset_matches_jax(god, variant):
    """Train and val splits; with rest z-scoring and the normalization
    statistics of train reused on val; an explicit channel list; and the
    per-region onset epoching (no filter or resample)."""
    from meg_decoding_tpu.data import god as jg
    from meg_decoding_tpu_torch.data import god as tg

    extra = {}
    if variant == "normalized":
        extra = dict(z_scoring=True, normalize_meg=True,
                     normalize_image_features=True)
    jc, tc = _cfgs(god, **extra)
    kw = {}
    if variant == "manual_ch":
        kw = dict(manual_ch=[0, 2, 5, 11])
    elif variant == "onsets":
        kw = dict(onsets={"occipital/left": 0.05, "occipital/right": 0.1})
    j = jg.build_god_dataset(jc, "train", **kw)
    t = tg.build_god_dataset(tc, "train", device="cpu", **kw)
    normalized = variant == "normalized"
    _assert_same_dataset(t, j, with_stats=normalized)
    n_ch = {"manual_ch": 4}.get(variant, 8)
    n_t = 40 if variant == "onsets" else 20  # raw 200 Hz vs resampled 100 Hz
    assert t.X.shape == (80, n_ch, n_t)
    stats = dict(mean_X=j.mean_X, std_X=j.std_X, mean_Y=j.mean_Y, std_Y=j.std_Y)
    jv = jg.build_god_dataset(jc, "val", **stats, **kw)
    tv = tg.build_god_dataset(tc, "val", **stats, device="cpu", **kw)
    _assert_same_dataset(tv, jv, with_stats=False)
    assert (np.diff(tv.labels.numpy()) >= 0).all()  # grouped by label


def test_build_god_dataset_averages_repeated_images(god, tmp_path):
    """Val epochs sharing (image, subject) are averaged: relabel the val
    session so images repeat."""
    from meg_decoding_tpu.data import god as jg
    from meg_decoding_tpu_torch.data import god as tg

    root = str(tmp_path / "rep")
    shutil.copytree(god.data_root, root)
    for sub in ("sbj01", "sbj02"):
        path = os.path.join(root, sub, "labels", "val.mat")
        m = scipy.io.loadmat(path)
        scipy.io.savemat(path, {"vec_image": m["vec_image"],
                                "vec_index": (np.arange(10) % 4 + 1)[None]})
    jc, tc = _cfgs(god, data_root=root)
    j = jg.build_god_dataset(jc, "val")
    t = tg.build_god_dataset(tc, "val", device="cpu")
    assert len(t) == 8  # 4 images × 2 subjects
    _assert_same_dataset(t, j, with_stats=False)


def test_packed_dataset_gather_and_subset():
    from meg_decoding_tpu_torch.data.packed import PackedDataset

    X = torch.arange(24.0).reshape(6, 2, 2)
    ds = PackedDataset(X=X, Y=X[:, 0], subject_idxs=torch.arange(6) % 2,
                       labels=torch.arange(6) + 1)
    X2, Y2, s2, l2 = ds.gather(np.array([4, 1]))
    assert torch.equal(X2, X[[4, 1]]) and torch.equal(l2, torch.tensor([5, 2]))
    sub = ds.subset(np.array([5, 0, 2]))
    assert len(sub) == 3 and torch.equal(sub.gather(torch.tensor([0]))[3],
                                         torch.tensor([6]))
    assert len(PackedDataset(X=X, Y=X, subject_idxs=X[:, 0, 0]).gather([0])) == 3
