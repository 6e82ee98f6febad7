"""The port's preprocessing and cache building against the JAX package, on
the CPU: ``data/gwilliams.py:preprocess_recordings``, the FIR design
against the committed golden taps, ``utils/cache.py``, the Gwilliams cache
builder (``cli/build_gwilliams_cache.py`` against
``scripts/build_gwilliams_cache.py``: the host helpers, ``build_x``'s
refusal without mne_bids, ``build_y`` and ``main``'s directory choice),
and the Brennan audio embedding (``data/brennan.py:embed_brennan_audio``
against JAX ``cli/train_speech.py:_embed_brennan_audio``), then the
Brennan train CLI with audio and no stream.

The embeddings run a wav2vec2 with the real conv geometry (7 layers,
kernels (10, 3, 3, 3, 3, 2, 2), strides (5, 2, 2, 2, 2, 2, 2): 320 samples
a frame) at tiny widths (16 conv channels, hidden 16, 4 layers, 2 heads),
``load_wav2vec`` monkeypatched in both packages to the same weights
(drawn as ``tests/test_torch_port_features.py`` draws them).

Tolerances, each with its reason:
* ``preprocess_recordings`` — max|Δ| ≤ 1e-5·max|X|: f32 FFTs of two
  libraries at other lengths (the port one FFT convolution, JAX
  power-of-two overlap-save and Bluestein transforms);
* the FIR taps — rtol 1e-12, as ``tests/test_golden_fir.py`` pins them
  (the same numpy/scipy design);
* the cache directories and settings, the host helpers — exact;
* the embeddings (``build_y``, the Brennan stream) — max|Δ| ≤
  1e-5·max|ref|: the encoder's f32 rounding, then an FFT resample.
"""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.core.config import Config, to_dict
from tests.test_torch_port_features import _random_flax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import build_gwilliams_cache as jbuild  # noqa: E402

from meg_decoding_tpu_torch.cli import build_gwilliams_cache as pbuild  # noqa: E402

RTOL = 1e-5
W2V_GEOM = dict(hidden_size=16, num_hidden_layers=4, num_attention_heads=2,
                intermediate_size=32, do_stable_layer_norm=True,
                feat_extract_norm="layer", conv_dim=(16,) * 7,
                conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                conv_stride=(5, 2, 2, 2, 2, 2, 2),
                num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# --- preprocessing ----------------------------------------------------------

def test_preprocess_recordings_matches_jax():
    """12 channels × 20 s at 1000 Hz, 1–60 Hz, then 120 Hz (the Gwilliams
    settings of configs/config.yaml)."""
    from meg_decoding_tpu.data.gwilliams import preprocess_recordings as jpre
    from meg_decoding_tpu_torch.data.gwilliams import preprocess_recordings

    raw = np.random.RandomState(0).randn(2, 12, 20000).astype(np.float32)
    want = jpre(raw, 1000.0, 1.0, 60.0, 120.0)
    got = preprocess_recordings(raw, 1000.0, 1.0, 60.0, 120.0, device="cpu")
    assert got.shape == want.shape == (2, 12, 2400)
    assert float((got.numpy() - want).__abs__().max()) <= RTOL * float(
        np.abs(want).max())


GOLDEN = os.path.join(ROOT, "meg_decoding_tpu", "data", "golden")


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(GOLDEN)
                                        if n.startswith("fir_self_")))
def test_fir_design_matches_the_golden_taps(name):
    from meg_decoding_tpu_torch.ops.fir import design_bandpass_fir

    g = np.load(os.path.join(GOLDEN, name))
    h = design_bandpass_fir(float(g["sfreq"]), float(g["l_freq"]),
                            float(g["h_freq"]))
    assert len(h) == len(g["h"])
    np.testing.assert_allclose(h, g["h"], rtol=1e-12, atol=1e-15)


# --- utils/cache.py ---------------------------------------------------------

def _cache_walk(cache, base):
    """One call sequence: two settings, a repeat, the done flags, a hole
    in the numbering (dir 1 deleted), a third settings; → what it saw."""
    import shutil

    pre_a = {"brain_resample_rate": 120, "seq_len_sec": 3, "mode": "x"}
    pre_b = {"brain_resample_rate": 100, "seq_len_sec": 3}
    seen = []
    d_a, *flags = cache.check_preprocs(pre_a, base)
    seen.append((os.path.basename(d_a), *flags))
    d_b, *flags = cache.check_preprocs(pre_b, base)
    seen.append((os.path.basename(d_b), *flags))
    cache.mark_done(d_a, "x_done")
    # excluded keys and the flags do not enter the match
    d, *flags = cache.check_preprocs({**pre_a, "mode": "y", "x_done": False},
                                     base)
    seen.append((os.path.basename(d), *flags))
    seen.append((cache.is_done(d_a, "x_done"), cache.is_done(d_a, "y_done"),
                 cache.is_done(os.path.join(base, "absent"), "x_done")))
    shutil.rmtree(d_b)
    d_c, *flags = cache.check_preprocs({"brain_resample_rate": 50}, base)
    seen.append((os.path.basename(d_c), *flags))
    seen.append(cache.config_hash(pre_a))
    settings = {n: json.load(open(os.path.join(base, n, "settings.json")))
                for n in sorted(os.listdir(base))}
    return seen, settings


def test_cache_directories_match_jax(tmp_path):
    from meg_decoding_tpu.utils import cache as jcache
    from meg_decoding_tpu_torch.utils import cache

    want = _cache_walk(jcache, str(tmp_path / "jax"))
    got = _cache_walk(cache, str(tmp_path / "port"))
    assert got == want
    assert [s[0] for s in got[0][:3]] == ["0", "1", "0"]
    assert got[0][4][0] == "1"  # the first unused number, not len(dirs)


# --- the cache builder's host helpers ---------------------------------------

def _annot_df(entries, onsets_sec):
    desc = [str({"start": s, "kind": k, "sequence_id": q})
            for (s, k, q) in entries]
    onset = [pd.Timestamp(2020, 1, 1) + pd.Timedelta(seconds=float(t))
             for t in onsets_sec]
    return pd.DataFrame({"description": desc, "onset": onset})


def test_builder_host_helpers_match_jax():
    t = pd.Timestamp("2020-01-01 01:12:34.250")
    assert pbuild.to_second(t) == jbuild.to_second(t)
    s = np.array([0.0, 4.0, 9.5, 0.2, 3.0, 3.0, 0.1, 1.0])
    np.testing.assert_array_equal(pbuild.continuous_onsets(s),
                                  jbuild.continuous_onsets(s))
    entries = [(0.0, "phoneme", 0), (0.0, "word", 0), (1.2, "phoneme", 0),
               (2.5, "word", 1), (8.0, "word", 1), (0.05, "word", 2),
               (0.9, "phoneme", 2), (1.5, "word", 3)]
    df = _annot_df(entries, [10.0, 10.0, 11.2, 12.5, 18.0, 18.1, 18.9, 19.5])
    for a, b in zip(pbuild._extract_annotations(df),
                    jbuild._extract_annotations(df)):
        np.testing.assert_array_equal(a, b)
    accs = []
    for mod in (pbuild, jbuild):
        acc = {"meg_onsets": {}, "speech_onsets": {}, "sentence_idxs": {}}
        keys = [mod.accumulate_session(acc, 0, 0, 2, df),
                mod.accumulate_session(acc, 4, 1, 2, df)]
        accs.append((keys, acc))
    (pk, pa), (jk, ja) = accs
    assert pk == jk == ["subject01_sess0_task2", "subject05_sess1_task2"]
    for name in pa:
        assert pa[name].keys() == ja[name].keys()
        for k in pa[name]:
            np.testing.assert_array_equal(pa[name][k], ja[name][k])
    # a session whose onsets differ from its task's: JAX asserts, the port
    # raises ValueError with the same message
    other = _annot_df([(0.7, "word", 0)], [1.0])
    with pytest.raises(ValueError, match="Speech onsets"):
        pbuild.accumulate_session(pa, 1, 0, 2, other)
    with pytest.raises(AssertionError, match="Speech onsets"):
        jbuild.accumulate_session(ja, 1, 0, 2, other)
    assert pbuild.TASK_PREFIXES == jbuild.TASK_PREFIXES


def test_build_x_without_mne_bids_exits_like_jax(tmp_path):
    cfg = Config({"root_dir": str(tmp_path), "preprocs": {}})
    with pytest.raises(SystemExit) as got:
        pbuild.build_x(cfg, str(tmp_path), device="cpu")
    with pytest.raises(SystemExit) as want:
        jbuild.build_x(JConfig(to_dict(cfg)), str(tmp_path))
    assert str(got.value) == str(want.value)
    assert "mne_bids" in str(got.value)


# --- embeddings -------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_w2v():
    """(Flax model, params, the port's model with the same weights) at the
    real conv geometry."""
    from transformers import FlaxWav2Vec2Model, Wav2Vec2Config as HFConfig

    from meg_decoding_tpu_torch.features.wav2vec2_model import (
        Wav2Vec2Config,
        Wav2Vec2Model,
    )
    from meg_decoding_tpu_torch.interop import encoder_params_from_flax

    flax_model = FlaxWav2Vec2Model(HFConfig(vocab_size=16, **W2V_GEOM),
                                   _do_init=False)
    cfg = Wav2Vec2Config.from_dict(W2V_GEOM)
    params = _random_flax_params(Wav2Vec2Model, cfg, 5)
    model = Wav2Vec2Model(cfg)
    model.load_state_dict(encoder_params_from_flax(params, model))
    return flax_model, params, model.eval().requires_grad_(False)


def _patch_loaders(monkeypatch, tiny_w2v):
    from meg_decoding_tpu.features import wav2vec as jw2v
    from meg_decoding_tpu_torch.features import wav2vec

    flax_model, params, model = tiny_w2v
    monkeypatch.setattr(jw2v, "load_wav2vec", lambda *a, **k: (flax_model, params))
    monkeypatch.setattr(wav2vec, "load_wav2vec", lambda *a, **k: model)


def _write_wav(path, sr, seconds, seed, int16=False):
    w = 0.3 * np.random.RandomState(seed).randn(int(sr * seconds))
    data = (w * 32767).astype(np.int16) if int16 else w.astype(np.float32)
    from scipy.io import wavfile

    wavfile.write(path, sr, data)


def test_build_y_and_main_match_jax(tiny_w2v, tmp_path, monkeypatch):
    """An audio file for each task prefix, 20.5–22 s (two chunks of 20 s
    each: the chunked, masked path), one of int16 samples, one at 8 kHz,
    embedded by both builders; then the port's ``main`` picks the cache
    directory whose settings match, skips ``build_x`` (marked done) and
    writes ``y_dict.npy``."""
    from meg_decoding_tpu.utils.cache import check_preprocs as jcheck
    from meg_decoding_tpu_torch.utils.cache import check_preprocs, mark_done

    _patch_loaders(monkeypatch, tiny_w2v)
    audio = tmp_path / "data" / "Gwilliams2022" / "stimuli" / "audio"
    audio.mkdir(parents=True)
    for t, prefix in enumerate(pbuild.TASK_PREFIXES):
        _write_wav(str(audio / f"{prefix}_0.wav"), 8000 if t == 2 else 16000,
                   20.5 + 0.5 * t, t, int16=t == 1)
    cfg = Config({"root_dir": str(tmp_path), "wav2vec_backend": "random",
                  "preprocs": {"audio_resample_rate": 16000,
                               "brain_resample_rate": 120}})
    jdir, _, _ = jcheck(dict(to_dict(cfg.preprocs)), str(tmp_path / "jax"))
    jbuild.build_y(JConfig(to_dict(cfg)), jdir)
    pdir, _, _ = check_preprocs(dict(to_dict(cfg.preprocs)),
                                str(tmp_path / "port"))
    got = pbuild.build_y(cfg, pdir, device="cpu")
    want = np.load(os.path.join(jdir, "y_dict.npy"), allow_pickle=True).item()
    assert got.keys() == want.keys() == {f"task{t}" for t in range(4)}
    for k in want:
        assert _rel(got[k], want[k]) <= RTOL, k
    # each file brought to 120 Hz: 20.5, 21, 21.5, 22 s
    assert [want[f"task{t}"].shape for t in range(4)] == [
        (16, 2460), (16, 2520), (16, 2580), (16, 2640)]

    base = str(tmp_path / "data" / "Gwilliams2022" / "preprocessed")
    other, _, _ = check_preprocs({"brain_resample_rate": 50}, base)
    mine, _, _ = check_preprocs(dict(to_dict(cfg.preprocs)), base)
    mark_done(mine, "x_done")
    out = pbuild.main(["--device", "cpu", "--config-path",
                       str(_write_config(tmp_path, cfg)), "--config-name",
                       "build"])
    assert out == mine != other
    stored = np.load(os.path.join(mine, "y_dict.npy"), allow_pickle=True).item()
    for k in want:
        assert _rel(stored[k], want[k]) <= RTOL, k
    assert json.load(open(os.path.join(mine, "settings.json")))["y_done"]


def _write_config(tmp_path, cfg) -> str:
    import yaml

    d = tmp_path / "configs"
    d.mkdir(exist_ok=True)
    (d / "build.yaml").write_text(yaml.safe_dump(to_dict(cfg)))
    return str(d)


def _brennan_audio(root, seconds, sr=22050, n_files=2):
    audio = os.path.join(root, "data", "Brennan2018", "audio")
    os.makedirs(audio, exist_ok=True)
    for i in range(n_files):
        _write_wav(os.path.join(audio, f"DownTheRabbitHoleFinal_SoundFile{i + 1}.wav"),
                   sr, seconds / n_files, 20 + i)


@pytest.mark.parametrize("last4", [True, False])
def test_embed_brennan_audio_matches_jax(tiny_w2v, tmp_path, monkeypatch,
                                         last4):
    """Two files at 22,050 Hz, 21 s in all (brought to 16 kHz: two
    chunks), the last-4 average or the conv features, then the brain rate
    (120 Hz)."""
    from meg_decoding_tpu.cli.train_speech import _embed_brennan_audio
    from meg_decoding_tpu_torch.data.brennan import embed_brennan_audio

    _patch_loaders(monkeypatch, tiny_w2v)
    _brennan_audio(str(tmp_path), 21.0)
    cfg = Config({"root_dir": str(tmp_path), "preprocs": {
        "audio_resample_rate": 16000, "brain_resample_rate": 120,
        "last4layers": last4}})
    want = _embed_brennan_audio(JConfig(to_dict(cfg)), str(tmp_path / "j.npy"))
    got = embed_brennan_audio(cfg, str(tmp_path / "p" / "y.npy"), device="cpu")
    assert got.shape == want.shape == (16, 2520)
    assert _rel(got, want) <= RTOL
    assert _rel(np.load(tmp_path / "p" / "y.npy"), want) <= RTOL


def test_brennan_train_cli_embeds_a_missing_stream(tiny_w2v, tmp_path,
                                                   monkeypatch):
    """Brennan with its audio and no stream: the train CLI embeds the
    audio (conv features, F = 16), saves the stream, and trains; the eval
    CLI then reads the saved stream (no second embedding)."""
    from meg_decoding_tpu_torch.cli import evaluate_speech, train_speech
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_brennan_raw
    from meg_decoding_tpu_torch.features import wav2vec

    _patch_loaders(monkeypatch, tiny_w2v)
    root = str(tmp_path / "root")
    make_synthetic_brennan_raw(root, n_subjects=3, C=12, rec_sec=60.0, F=16,
                               seed=1)
    stream = os.path.join(root, "data", "Brennan2018", "Y_embeds",
                          "embd_wav2vec.npy")
    os.remove(stream)
    _brennan_audio(root, 60.0, sr=16000, n_files=2)
    args = ["--device", "cpu", "dataset=Brennan2018", f"root_dir={root}",
            f"save_root={tmp_path / 'out'}", "epochs=1", "updates=3",
            "D1=16", "D2=24", "K=4", "F=16", "preprocs.last4layers=false",
            "batch_size=8", "run_name=b"]
    with pytest.warns(UserWarning, match="synthetic cap"):
        best = train_speech.main(args)
    assert best["train_skipped"] == 0.0 and np.isfinite(best["train_loss"])
    Y = np.load(stream)
    assert Y.shape == (16, 7200) and np.isfinite(Y).all()

    def refuse(*a, **k):
        raise AssertionError("the eval CLI embedded the audio again")

    monkeypatch.setattr(wav2vec, "load_wav2vec", refuse)
    with pytest.warns(UserWarning, match="synthetic cap"):
        res = evaluate_speech.main(args)
    assert 0.0 <= res["test_top1"] <= res["test_top10"] <= 1.0
