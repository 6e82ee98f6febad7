"""Port modules (meg_decoding_tpu_torch) against their JAX counterparts on the
CPU, at small sizes: the same numpy inputs through both, weights carried
across with ``interop.params_from_jax``.

Tolerances, each with its reason:
* collate — rtol 1e-5: the baseline mean sums in another order;
* encoder (f32) — rtol/atol 1e-4: convolutions and matmuls accumulate in
  another order through every block;
* encoder (bf16 compute) — relative L2 2e-2: the two frameworks round bf16
  intermediates at other places;
* CLIP logits / loss / metric values — 1e-5; top-k hits exactly equal;
* host-side data code (config, layout, splits, packing) — exactly equal.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax, split_loss_params

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")
C, T, B = 12, 96, 4
D1, D2, F, K, S = 16, 24, 16, 4, 3


def _loc(n=C, seed=0):
    rng = np.random.RandomState(seed)
    loc = rng.rand(n, 2).astype(np.float32)
    loc = (loc - loc.min(0)) / (loc.max(0) - loc.min(0))
    return loc * 0.8 + 0.1


def _random_variables(module, X0, subs0, seed=0):
    """Random numpy variables of ``module``'s shape tree (``eval_shape``
    compiles nothing): weights in torch's default ranges, non-trivial BN
    parameters and running statistics."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), X0, subs0)

    def fill(path, s):
        name = path[-1].key
        if name in ("z_re", "z_im"):
            a = rng.rand(*s.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.randn(*s.shape)
        else:  # Dense/Conv kernels (..., in, out), subject weights (S, in, out)
            fan_in = int(np.prod(s.shape[:-1])) if name == "kernel" else s.shape[-2]
            a = rng.uniform(-1, 1, s.shape) / np.sqrt(fan_in)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(jm, variables, X, subs):
    fn = jax.jit(lambda v, x, s: jm.apply(v, x, s, train=False))
    return np.asarray(fn(variables, jnp.asarray(X), jnp.asarray(subs)))


def _encoder_pair(seq2seq=True, num_blocks=2, dtype=None, gelu_impl=None):
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder as TEnc

    loc = _loc()
    jm = JEnc(loc=loc, num_subjects=S, D1=D1, D2=D2, F=F, K=K,
              seq2seq=seq2seq, num_blocks=num_blocks,
              dtype=None if dtype is None else jnp.bfloat16,
              gelu_impl=gelu_impl)
    variables = _random_variables(jm, jnp.zeros((2, C, T), jnp.float32),
                                  jnp.zeros(2, jnp.int32))
    tm = TEnc(loc, S, D1=D1, D2=D2, F=F, K=K, seq2seq=seq2seq,
              num_blocks=num_blocks, dtype=dtype, gelu_impl=gelu_impl,
              device="cpu")
    model_sd, _ = split_loss_params(params_from_jax(variables))
    tm.load_state_dict(model_sd)  # strict: every name maps 1:1
    return jm, variables, tm.eval()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, C, T).astype(np.float32)
    subs = rng.randint(0, S, B).astype(np.int32)
    return X, subs


# --- collate -----------------------------------------------------------------

@pytest.mark.parametrize("jax_impl", ["sort", "pallas"])
def test_collate_matches_jax(jax_impl):
    from meg_decoding_tpu.ops.scaling import collate_preprocess as jcollate
    from meg_decoding_tpu_torch.ops.scaling import collate_preprocess

    rng = np.random.RandomState(3)
    X = (rng.randn(B, C, T) * rng.lognormal(size=(B, C, 1)) * 5).astype(np.float32)
    X[0, 0] = 2.5          # constant channel → IQR fallback 1.0
    X[1, 2, :40] = 300.0   # outliers that the clamp cuts
    want = np.asarray(jcollate(jnp.asarray(X), 60, 20.0, True,
                               quantile_impl=jax_impl))
    got = collate_preprocess(torch.from_numpy(X), 60, 20.0, True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_robust_stats_iqr_fallback_and_cached_path():
    from meg_decoding_tpu_torch.ops.scaling import (
        collate_preprocess,
        collate_preprocess_cached,
        robust_stats,
    )

    rng = np.random.RandomState(4)
    X = torch.from_numpy(rng.randn(B, C, T).astype(np.float32))
    X[0, 1] = 7.0
    X[0, 2] = 1e-3 + 1e-9 * torch.arange(T)  # IQR 1.8e-7 < 10·eps
    med, iqr = robust_stats(X)
    assert iqr[0, 1] == 1.0 and iqr[0, 2] == 1.0 and med[0, 1] == 7.0
    # cached stats of the baseline-corrected window give the inline result
    Xb = X - X[..., :30].mean(-1, keepdim=True)
    med, iqr = robust_stats(Xb)
    torch.testing.assert_close(collate_preprocess_cached(X, med, iqr, 30, 20.0),
                               collate_preprocess(X, 30, 20.0), rtol=0, atol=0)


def test_percentile_sorted_matches_jax():
    from meg_decoding_tpu.ops.scaling import _percentile_sorted as jps
    from meg_decoding_tpu_torch.ops.scaling import _percentile_sorted as tps

    xs = np.sort(np.random.RandomState(5).randn(6, 37).astype(np.float32), -1)
    for q in (0.0, 25.0, 50.0, 75.0, 100.0):
        np.testing.assert_allclose(tps(torch.from_numpy(xs), q).numpy(),
                                   np.asarray(jps(jnp.asarray(xs), q)),
                                   rtol=1e-6, atol=1e-7)


# --- GELU ----------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["erf", "tanh", "erf_poly"])
def test_gelu_matches_jax(impl):
    from meg_decoding_tpu.ops.gelu import gelu as jgelu
    from meg_decoding_tpu_torch.ops.gelu import gelu, resolve_impl

    x = np.linspace(-6, 6, 4001).astype(np.float32)
    got = gelu(torch.from_numpy(x), impl).numpy()
    want = np.asarray(jgelu(jnp.asarray(x), impl))
    # f32: erf/tanh are library transcendentals on both sides (a few ulp,
    # and up to ~6e-7 absolute in the far negative tail where the output
    # underflows towards -0); erf_poly is the same polynomial
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    assert resolve_impl(None, True) == "tanh" and resolve_impl("erf_poly", True) == "erf_poly"


# --- layers and encoder --------------------------------------------------------

def test_fourier_basis_and_attention_weights_match_jax():
    from meg_decoding_tpu.models import layers as jl
    from meg_decoding_tpu_torch.models import layers as tl

    loc = _loc()
    jc, js = jl.fourier_basis(loc, K)
    tc, ts = tl.fourier_basis(loc, K)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ts, js)
    rng = np.random.RandomState(6)
    z_re, z_im = rng.rand(2, D1, K * K).astype(np.float32)
    want = np.asarray(jl.spatial_attention_weights(z_re, z_im, jc, js))
    got = tl.spatial_attention_weights(*map(torch.from_numpy,
                                            (z_re, z_im, tc, ts))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seq2seq", [True, False])
def test_brain_encoder_eval_matches_flax_f32(seq2seq):
    jm, variables, tm = _encoder_pair(seq2seq=seq2seq)
    X, subs = _inputs()
    want = _apply(jm, variables, X, subs)
    with torch.no_grad():
        got = tm(torch.from_numpy(X), torch.from_numpy(subs)).numpy()
    assert got.shape == want.shape == ((B, F, T) if seq2seq else (B, F))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_brain_encoder_erf_poly_and_five_blocks_match_flax():
    jm, variables, tm = _encoder_pair(num_blocks=5, gelu_impl="erf_poly")
    X, subs = _inputs(1)
    want = _apply(jm, variables, X, subs)
    with torch.no_grad():
        got = tm(torch.from_numpy(X), torch.from_numpy(subs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seq2seq", [False, True])
def test_brain_encoder_bf16_compute_matches_flax(seq2seq):
    jm, variables, tm = _encoder_pair(dtype=torch.bfloat16, seq2seq=seq2seq)
    assert tm.time_major  # the bf16 conv stack runs (B, T, C)
    X, subs = _inputs(2)
    want = _apply(jm, variables, X, subs)
    with torch.no_grad():
        got = tm(torch.from_numpy(X), torch.from_numpy(subs))
    assert got.dtype == torch.float32  # emit_f32
    assert got.shape == want.shape and got.is_contiguous()
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


def _layouts(model):
    """Each submodule's layout flag, by name."""
    return {n: m.time_major for n, m in model.named_modules()
            if hasattr(m, "time_major")}


def _as_ncw(model):
    """A copy of ``model`` (same weights) on the NCW route."""
    import copy

    ncw = copy.deepcopy(model)
    for m in ncw.modules():
        if hasattr(m, "time_major"):
            m.time_major = False
    return ncw


@pytest.mark.parametrize("kind", ["seq2seq", "mean", "seq2static"])
@pytest.mark.parametrize("train", [True, False])
def test_bf16_time_major_route_matches_the_ncw_route(kind, train):
    """A bf16 encoder on its time-major route against the same weights on
    the NCW route, in training (forward, then every parameter's gradient)
    and in eval mode.  The two routes run the same bf16 operations, but the
    BN sums run over the elements in another order and the CPU's
    convolutions may accumulate in another order on the other layout, which
    can move a bf16 rounding by one ulp (2^-8): the outputs within relative
    L2 1e-3 of each other.  In the backward such a flip carries through the
    blocks, so each gradient (f32) is held within 2e-2 of its norm: bf16's
    own error on these gradients, against the same model in f32, is 0.4-4 %
    (subject block 3.4-3.6 %).  f32 models stay NCW."""
    from meg_decoding_tpu_torch.models.brain_encoder import (
        BrainEncoder, BrainEncoderSeq2Static)

    gen = torch.Generator().manual_seed(7)
    common = dict(D1=D1, D2=D2, F=F, K=K, device="cpu", generator=gen)
    T_ = 64 if kind == "seq2static" else T  # its pools need T >= 31
    def make(dt):
        if kind == "seq2static":
            return BrainEncoderSeq2Static(_loc(), S, [3, 3, 3, 3, 3], dtype=dt,
                                          **common)
        return BrainEncoder(_loc(), S, seq2seq=kind == "seq2seq",
                            num_blocks=3, dtype=dt, **common)

    assert not any(_layouts(make(None)).values())  # f32: NCW throughout
    tm = make(torch.bfloat16).train(train)
    flags = _layouts(tm)
    # the stack is time-major from the subject layer to conv_final1; the
    # SubjectBlock's 1x1 conv and conv_final2 take (B, C, T)
    assert flags.pop("subject_block.conv") is False
    assert flags.pop("conv_final2") is False
    assert all(flags.values()), flags
    ncw = _as_ncw(tm)
    rng = np.random.RandomState(3)
    X = torch.from_numpy(rng.randn(B, C, T_).astype(np.float32))
    subs = torch.from_numpy(rng.randint(0, S, B))
    outs = []
    for model in (tm, ncw):
        if train:
            out = model(X, subs, centre=2)
            out.float().square().mean().backward()
        else:
            with torch.no_grad():
                out = model(X, subs)
        outs.append(out.detach())
    assert outs[0].shape == outs[1].shape and outs[0].is_contiguous()
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    assert rel < 1e-3, rel
    if train:
        grads = {n: (a.grad, b.grad) for (n, a), (_, b) in
                 zip(tm.named_parameters(), ncw.named_parameters())}
        for name, (a, b) in grads.items():
            assert a is not None, name
            # a conv bias that a BatchNorm follows has a true gradient of 0,
            # so rounding noise alone: measured against its weight's
            ref = (grads[name[:-4] + "weight"][1] if re.search(
                r"conv\d\.conv[01]\.bias$", name) else b)
            gap = float((a - b).norm() / ref.norm())
            assert gap < 2e-2, (name, gap)


def test_state_dict_names_follow_flax():
    jm, variables, tm = _encoder_pair()
    names = set(tm.state_dict())
    for n in ("subject_block.spatial_attention.z_re",
              "subject_block.spatial_attention.z_im",
              "subject_block.conv.weight", "subject_block.subject_layer.weight",
              "conv0.conv0.weight", "conv1.conv2a.weight", "conv1.conv2b.bias",
              "conv0.bn0.scale", "conv1.bn1.mean", "conv1.bn1.var",
              "conv_final1.weight", "conv_final2.bias"):
        assert n in names, n
    sd = params_from_jax({"params": {"model": variables["params"],
                                     "loss": {"temp": np.float32(5.1)}},
                          "batch_stats": variables["batch_stats"]})
    model_sd, loss = split_loss_params(sd)
    assert set(model_sd) == names
    assert float(loss["temp"]) == pytest.approx(5.1)
    k = np.asarray(variables["params"]["conv1"]["conv0"]["kernel"])  # (ks, in, out)
    np.testing.assert_array_equal(model_sd["conv1.conv0.weight"].numpy(),
                                  np.transpose(k, (2, 1, 0)))


def test_get_model_reads_the_speech_config():
    from meg_decoding_tpu_torch.core.config import compose
    from meg_decoding_tpu_torch.models.factory import get_model

    cfg = compose(CONFIGS, "config", ["D1=8", "D2=8", "K=2"])
    cfg.num_subjects = 2
    m = get_model(cfg, _loc(), device="cpu", seed=3)
    assert m.seq2seq and m.conv_final2.weight.shape == (1024, 16)  # last4layers
    m2 = get_model(cfg, _loc(), device="cpu", seed=3)
    torch.testing.assert_close(m.state_dict(), m2.state_dict())  # seeded init
    cfg.model = "eegnet"  # needs the channel count
    with pytest.raises(ValueError, match="num_channels"):
        get_model(cfg, _loc(), device="cpu")
    cfg.model = "no_such_model"
    with pytest.raises(ValueError, match="no model named"):
        get_model(cfg, _loc(), device="cpu")


# --- objectives ------------------------------------------------------------

@pytest.mark.parametrize("impl", ["factored", "normalized"])
def test_clip_logits_and_loss_match_jax(impl):
    from meg_decoding_tpu.objectives import clip as jc
    from meg_decoding_tpu_torch.objectives import clip as tc

    rng = np.random.RandomState(7)
    x = rng.randn(8, 5, 6).astype(np.float32)
    y = (x + 0.5 * rng.randn(8, 5, 6)).astype(np.float32)
    y[3] = 0.0  # a zero row: the EPS² clamp sits inside the sqrt
    temp = np.float32(2.3)
    jl, jloss = jc.clip_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(temp),
                             return_logits=True, impl=impl)
    tl, tloss = tc.clip_loss(torch.from_numpy(x), torch.from_numpy(y),
                             torch.tensor(temp), return_logits=True, impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    s_sum = tc.clip_loss(torch.from_numpy(x), torch.from_numpy(y),
                         torch.tensor(temp), reduction="sum", impl=impl)
    assert float(s_sum) == pytest.approx(8 * float(tloss), rel=1e-5)


def test_retrieval_metrics_match_jax():
    from meg_decoding_tpu.objectives import retrieval as jr
    from meg_decoding_tpu_torch.objectives import retrieval as tr

    rng = np.random.RandomState(8)
    Y = rng.randn(24, 4, 5).astype(np.float32)
    Z = (Y + 1.2 * rng.randn(24, 4, 5)).astype(np.float32)
    jZ, jY, tZ, tY = jnp.asarray(Z), jnp.asarray(Y), torch.from_numpy(Z), torch.from_numpy(Y)
    np.testing.assert_allclose(tr.cosine_similarity_matrix(tZ, tY).numpy(),
                               np.asarray(jr.cosine_similarity_matrix(jZ, jY)),
                               rtol=1e-5, atol=1e-6)
    want = jr.retrieval_accuracy(jZ, jY, top_ks=(1, 5, 10))
    got = tr.retrieval_accuracy(tZ, tY, top_ks=(1, 5, 10))
    for k in want:  # hit counts exactly equal
        assert round(float(got[k]) * 24) == round(float(want[k]) * 24), k
    for metric in ("correlation", "cosine"):
        np.testing.assert_allclose(
            tr.pairwise_identification(tZ, tY, metric).numpy(),
            np.asarray(jr.pairwise_identification(jZ, jY, metric)), atol=1e-6)


# --- config, layout, synthetic data, splits, packing -----------------------

def test_config_compose_matches_jax():
    from meg_decoding_tpu.core.config import compose as jcompose, to_dict as jto
    from meg_decoding_tpu_torch.core.config import compose, to_dict

    ov = ["batch_size=32", "+extra.key=3", "preprocs.clamp_lim=10"]
    assert to_dict(compose(CONFIGS, "config", ov)) == \
        jto(jcompose(CONFIGS, "config", ov))


def test_layouts_match_jax(tmp_path):
    from meg_decoding_tpu.core.config import Config as JConfig
    from meg_decoding_tpu.data.layout import ch_locations_2d as jloc
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.data.layout import ch_locations_2d

    rng = np.random.RandomState(9)
    np.save(tmp_path / "layout.npy", rng.rand(20, 3).astype(np.float32))
    csv = tmp_path / "coords.csv"
    np.savetxt(csv, rng.rand(10, 3), delimiter=",")
    cases = [
        {"dataset": "Gwilliams2022", "cache_dir": str(tmp_path), "num_channels": 20},
        {"dataset": "Gwilliams2022", "layout_csv": str(csv)},
        {"dataset": "Gwilliams2022", "num_channels": 30},  # synthetic cap
    ]
    with pytest.warns(UserWarning):
        np.testing.assert_array_equal(ch_locations_2d(Config(cases[2])),
                                      jloc(JConfig(cases[2])))
    for c in cases[:2]:
        np.testing.assert_array_equal(ch_locations_2d(Config(c)), jloc(JConfig(c)))


def test_synthetic_cache_matches_jax(tmp_path):
    from meg_decoding_tpu.data.synthetic import make_synthetic_gwilliams_cache as jmake
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache

    kw = dict(n_subjects=2, n_sessions_per=1, C=6, rec_sec=12.0,
              words_per_task=8, F=4, seed=5)
    cfg = make_synthetic_gwilliams_cache(str(tmp_path / "t"), **kw)
    jcfg = jmake(str(tmp_path / "j"), **kw)
    assert cfg.preprocs.seq_len_sec == jcfg.preprocs.seq_len_sec
    for name in sorted(os.listdir(tmp_path / "j")):
        if name.endswith(".npy"):
            a = np.load(tmp_path / "t" / name, allow_pickle=True)
            b = np.load(tmp_path / "j" / name, allow_pickle=True)
            if a.dtype == object:
                a, b = a.item(), b.item()
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                np.testing.assert_array_equal(a, b)


def test_splits_and_sessions_match_jax():
    from meg_decoding_tpu.data import gwilliams as jg
    from meg_decoding_tpu_torch.data import gwilliams as tg

    rng = np.random.RandomState(10)
    sent = {f"task{t}": np.sort(rng.randint(0, 9, 40)) for t in range(4)}
    onsets = {f"task{t}": np.sort(rng.uniform(0, 100, 40)) for t in range(4)}
    tr, te = tg.sentence_split(sent, 0.8, seed=3)
    jtr, jte = jg.sentence_split(sent, 0.8, seed=3)
    dtr = tg.drop_overlapping_words(tr, te, onsets, 3.0)
    jdtr = jg.drop_overlapping_words(jtr, jte, onsets, 3.0)
    dtr2, dte2 = tg.deep_split(onsets, 0.7)
    jdtr2, jdte2 = jg.deep_split(onsets, 0.7)
    for a, b in [(tr, jtr), (te, jte), (dtr, jdtr), (dtr2, jdtr2), (dte2, jdte2)]:
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    keys = ["subject01_sess0_task0", "subject01_sess0_task1",
            "subject01_sess0_task2", "subject01_sess0_task3",
            "subject02_sess0_task0"]
    assert tg.parse_sessions(keys) == jg.parse_sessions(keys)


def test_random_split_is_a_seeded_partition():
    from meg_decoding_tpu_torch.data.sampling import random_split

    tr, te = random_split(torch.Generator().manual_seed(0), 50, 0.8)
    tr2, _ = random_split(torch.Generator().manual_seed(0), 50, 0.8)
    assert len(tr) == 40 and len(te) == 10
    assert sorted(np.concatenate([tr, te]).tolist()) == list(range(50))
    np.testing.assert_array_equal(tr, tr2)
