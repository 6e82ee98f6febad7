"""The port's serving and eval slice against the JAX package, end to end on
the CPU: a synthetic Gwilliams cache → packed dataset → batch gather →
collate → eval encoder → CLIP loss and retrieval, with the same weights,
the same segment pools and the same session draws on both sides.

Tolerances: gathered windows are copies — bit-exact.  Z and the loss —
rtol/atol 1e-4 (the collate's baseline mean and every conv accumulate in
another order).  Top-k hits — exactly equal.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax, split_loss_params
from tests.test_torch_port_modules import _random_variables

D1, D2, K, NB = 16, 24, 4, 2
TEMP = np.float32(5.1)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    """A small cache (C=12, F=16, 40 Hz → T=120), both packed datasets and a
    model pair with identical weights."""
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu_torch.data import gwilliams as tg
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc

    cache = str(tmp_path_factory.mktemp("gw") / "cache")
    cfg = make_synthetic_gwilliams_cache(cache, n_subjects=3, n_sessions_per=1,
                                         C=12, rate=40, rec_sec=40.0,
                                         words_per_task=24, F=16, seed=1)
    raw = tg.load_gwilliams_cache(cache)
    j_tr, j_te = jg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence")
    t_tr, t_te = tg.build_gwilliams_dataset(cfg, *raw, split_mode="sentence",
                                            device="cpu")
    loc = ch_locations_2d(cfg)
    jm = JEnc(loc=loc, num_subjects=3, D1=D1, D2=D2, F=16, K=K, seq2seq=True,
              num_blocks=NB)
    L = t_te.seq_len
    variables = _random_variables(jm, jnp.zeros((2, 12, L), jnp.float32),
                                  jnp.zeros(2, jnp.int32), seed=1)
    tm = TEnc(loc, 3, D1=D1, D2=D2, F=16, K=K, seq2seq=True, num_blocks=NB,
              device="cpu")
    sd = params_from_jax({"params": {"model": variables["params"],
                                     "loss": {"temp": TEMP}},
                          "batch_stats": variables["batch_stats"]})
    model_sd, _ = split_loss_params(sd)
    tm.load_state_dict(model_sd)
    return dict(cfg=cfg, cache=cache, j_tr=j_tr, j_te=j_te, t_tr=t_tr,
                t_te=t_te, jm=jm, variables=variables, tm=tm.eval(), sd=sd)


def _collate_cfgs(cfg):
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu_torch.train.steps import CollateConfig

    rate = float(cfg.preprocs.brain_resample_rate)
    kw = dict(baseline_len_samp=int(rate * cfg.preprocs.baseline_len_sec),
              clamp_lim=float(cfg.preprocs.clamp_lim))
    return JCollate(**kw), CollateConfig(**kw)


def _pools(n, pool, seed):
    """Pools of segment ids and a session per segment, drawn with numpy."""
    rng = np.random.RandomState(seed)
    out = []
    for p in range(-(-n // pool)):
        start = min(p * pool, n - pool)
        out.append((np.arange(start, start + pool), rng.randint(0, 3, pool)))
    return out


def test_packed_dataset_matches_jax(slice_setup):
    s = slice_setup
    for j, t in ((s["j_tr"], s["t_tr"]), (s["j_te"], s["t_te"])):
        np.testing.assert_array_equal(t.recordings.numpy(), np.asarray(j.recordings))
        np.testing.assert_array_equal(t.y_stream.numpy(), np.asarray(j.y_stream))
        np.testing.assert_array_equal(t.meg_onsets.numpy(), np.asarray(j.meg_onsets))
        np.testing.assert_array_equal(t.speech_onsets.numpy(),
                                      np.asarray(j.speech_onsets))
        np.testing.assert_array_equal(t.n_words, j.n_words)
        np.testing.assert_array_equal(t.segment_table(), j.segment_table())
        assert (t.seq_len, t.num_subjects) == (j.seq_len, j.num_subjects)


@pytest.mark.parametrize("y_dtype", [None, "bf16"])
def test_batch_gather_matches_jax_bit_exact(slice_setup, y_dtype):
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu_torch.data.gwilliams import _gather_batch

    ds, jds = slice_setup["t_tr"], slice_setup["j_tr"]
    rng = np.random.RandomState(2)
    seg_ids = rng.randint(0, len(ds), 16)
    sess = rng.randint(0, ds.num_sessions, 16)
    seg = jds.segment_table()[seg_ids]
    JX, JY, Js = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                         jds.speech_onsets, jds.session_subject,
                         jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                         jnp.asarray(sess), jds.seq_len,
                         y_dtype=jnp.bfloat16 if y_dtype else None)
    X, Y, subs = _gather_batch(
        ds.recordings, ds.y_stream, ds.meg_onsets, ds.speech_onsets,
        ds.session_subject, torch.from_numpy(seg[:, 0]),
        torch.from_numpy(seg[:, 1]), torch.from_numpy(sess), ds.seq_len,
        y_dtype=torch.bfloat16 if y_dtype else None)
    np.testing.assert_array_equal(X.numpy(), np.asarray(JX))
    np.testing.assert_array_equal(Y.float().numpy(),
                                  np.asarray(JY, dtype=np.float32))
    np.testing.assert_array_equal(subs.numpy(), np.asarray(Js))


def test_eval_step_matches_jax_over_test_pools(slice_setup):
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_eval_step as jmake
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.train.steps import LossConfig, make_eval_step

    s = slice_setup
    jcol, tcol = _collate_cfgs(s["cfg"])
    jstep = jmake(s["jm"], JLoss(), jcol)
    tstep = make_eval_step(s["tm"], LossConfig(), tcol)
    params = {"model": s["variables"]["params"], "loss": {"temp": jnp.asarray(TEMP)}}
    jds, ds = s["j_te"], s["t_te"]
    for seg_ids, sess in _pools(len(ds), 16, seed=3):
        seg = jds.segment_table()[seg_ids]
        JX, JY, Js = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                             jds.speech_onsets, jds.session_subject,
                             jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                             jnp.asarray(sess), jds.seq_len)
        jmet, JZ = jstep(params, s["variables"]["batch_stats"], JX, JY, Js)
        X, Y, subs, _ = gather_speech_batch(ds, seg_ids, sess_ids=sess)
        met, Z = tstep(X, Y, subs, TEMP)
        np.testing.assert_allclose(Z.numpy(), np.asarray(JZ), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-4)
        for k in ("top1", "top10"):
            assert round(float(met[k]) * 16) == round(float(jmet[k]) * 16), k
        assert float(met["temp"]) == float(jmet["temp"])


def test_serving_forward_matches_jax(slice_setup):
    from meg_decoding_tpu.serving.export import make_serving_forward as jmake
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.serving.forward import make_serving_forward

    s = slice_setup
    jcol, tcol = _collate_cfgs(s["cfg"])
    rng = np.random.RandomState(4)
    X, _, subs, _ = gather_speech_batch(s["t_tr"], rng.randint(0, len(s["t_tr"]), 8),
                                        generator=torch.Generator().manual_seed(0))
    jfwd = jax.jit(jmake(s["jm"], jcol))
    want = np.asarray(jfwd(s["variables"], jnp.asarray(X.numpy()),
                           jnp.asarray(subs.numpy())))
    got = make_serving_forward(tcol)(s["tm"], X, subs)
    assert got.shape == (8, 16, s["t_tr"].seq_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_evaluate_cli_scores_every_test_segment(slice_setup, tmp_path):
    """The eval CLI on the CPU: checkpoint in the port's names under
    save_root/ckpt, every test segment scored, results written."""
    from meg_decoding_tpu_torch.cli.evaluate_speech import run
    from meg_decoding_tpu_torch.core.config import Config, to_dict
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d
    from meg_decoding_tpu_torch.models.factory import get_model

    s = slice_setup
    cfg = Config(dict(to_dict(s["cfg"]), model="brain_encoder", D1=D1, D2=D2,
                      K=K, F=16, seq2seq=True, batch_size=16, num_subjects=3,
                      save_root=str(tmp_path / "out")))
    model = get_model(cfg, ch_locations_2d(cfg), device="cpu", seed=7)
    (tmp_path / "out" / "ckpt").mkdir(parents=True)
    torch.save(dict(model.state_dict(), **{"loss.temp": torch.tensor(TEMP)}),
               tmp_path / "out" / "ckpt" / "model.pt")
    res = run(cfg, device="cpu")
    written = json.loads((tmp_path / "out" / "eval_results.json").read_text())
    assert written == res
    assert res["n_test_segments"] == len(s["j_te"])
    assert res["pool_size"] == 16
    assert res["n_pools"] == -(-len(s["j_te"]) // 16)
    for k in ("test_top1", "test_top10", "pairwise_correlation"):
        assert 0.0 <= res[k] <= 1.0
