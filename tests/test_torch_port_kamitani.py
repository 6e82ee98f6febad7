"""The port's Kamitani baseline against the JAX package, on the CPU: the
helpers, the masked ARD fit (``slir_fit``) in both branches and every
``prune_mode``, single and batched over units, the feature-prediction
pipeline with the identification rate, and the CLI against JAX's
``examples/kamitani_regression.py`` on a synthetic GOD set.

Tolerances, each with its reason:
* the numpy helpers — exactly (the same numpy code); ``corrmat`` rtol 1e-5
  (one f32 matmul, sums in another order);
* ``slir_fit``, primal branch (N > D), after 200 iterations — the
  pruning masks exactly, W and the noise variance SY rtol 1e-3 (W with an
  absolute 1e-5·max|W|), the alphas rtol 1e-2 with an absolute
  1e-4·max(A) (the alphas of irrelevant features shrink towards 0 as the
  iterations go, far below the relevant ones): the two sides agree to
  ~1e-6 at every iteration count;
* ``slir_fit``, dual branch (N < D) — after one iteration W rtol 1e-3
  with an absolute 1e-3·max|W|; after 200 the masks exactly and W zero on
  the pruned features.  In f32 the dual update ``W − (W·XC)·XA`` cancels
  most of its digits, the two packages' matmuls round it apart by ~1e-4
  in the first iteration, and the ARD iterations amplify that: in this
  interpolating regime the noise estimate falls to its fallback and W
  after 200 iterations differs between the packages by percents (measured
  up to 46× at one of 12 seeds and modes), on the CPU alike; the pruning
  decisions agree;
* ``slir_fit``, dual branch in float64 (JAX's source with its working
  type read as float64, under x64; the port with ``dtype=float64``), the
  witness that the f32 gap is rounding: after 1 / 20 / 200 iterations the
  masks exactly, W within 1e-11 / 1e-7 / 1e-4 of max|W|, A within 1e-11 /
  1e-5 / 1e-2 of max A, SY rtol 1e-11 / 1e-5 / 1e-2.  Measured at these
  inputs: 1e-13 after one iteration, ≤ 1e-9 / 3e-7 / 3e-7 after 20,
  ≤ 8e-6 / 2.5e-3 / 1.9e-3 after 200 — the gap grows from the last bit
  at the rate of the iteration's own sensitivity (moving one entry of X
  by one ulp moves the port's own result by 6e-7 / 1e-4 / 1.4e-3 after
  200 iterations at ``prune_mode`` 0);
* ``slir_fit``'s noise fallback in float64 (primal branch, N > D): Y
  in the span of one column of X that carries nearly all of X's variance,
  so from the second iteration on the quick estimate SY = (ΣY² − ΣW·YX) /
  (L·N) cancels to ~4e-8 of SY0 (asserted on JAX's own state: below the
  1e-6 at which both packages switch to the residual form).  There the
  residual Y − W·X cancels the same ~7.4 digits, so f64 keeps ~8: SY rtol
  1e-8, A within 1e-8 of max A, W (no such cancellation) within 1e-12 of
  max|W|, the masks exactly.  Measured 2.3e-11 / 2.3e-11 / 1e-16;
* the pipeline's predictions rtol 1e-3 (as W); the category-wise rates and
  the CLI's accuracy exactly (they count comparisons, and no correlation
  lies within rounding of another).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_helpers_match_jax():
    from meg_decoding_tpu.kamitani import helpers as jh
    from meg_decoding_tpu_torch.kamitani import helpers as th

    rng = np.random.RandomState(0)
    x, y = rng.randn(5, 30), rng.randn(7, 30)
    for axis in (0, 1):
        np.testing.assert_array_equal(th.add_bias(x, axis), jh.add_bias(x, axis))
    value = rng.randn(30)
    value[3] = np.nan
    for a, b in zip(th.select_top(x, value, 11, axis=1),
                    jh.select_top(x, value, 11, axis=1)):
        np.testing.assert_array_equal(a, b)
    for var in ("row", "col"):
        np.testing.assert_array_equal(th.corrcoef(x, x[::-1], var),
                                      jh.corrcoef(x, x[::-1], var))
        np.testing.assert_allclose(th.corrmat(x, y if var == "row" else x,
                                              var, device="cpu"),
                                   jh.corrmat(x, y if var == "row" else x, var),
                                   rtol=1e-5, atol=1e-6)


def _sparse_problem(N, D, L, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(np.float32)
    W = np.zeros((D, L), np.float32)
    W[: max(D // 5, 2)] = rng.randn(max(D // 5, 2), L) * 2.0
    Y = (X @ W + 0.3 * rng.randn(N, L)).astype(np.float32)
    return X, Y


def _assert_fit_close(got, want):
    W, A, SY, mask = (t.numpy() for t in got)
    jW, jA, jSY, jmask = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(W, jW, rtol=1e-3, atol=1e-5 * np.abs(jW).max())
    np.testing.assert_allclose(SY, jSY, rtol=1e-3)
    np.testing.assert_allclose(A, jA, rtol=1e-2, atol=1e-4 * np.abs(jA).max())


@pytest.mark.parametrize("prune_mode", [0, 1, 2])
@pytest.mark.parametrize("branch", ["primal", "dual"])
def test_slir_fit_matches_jax(branch, prune_mode):
    from meg_decoding_tpu.kamitani.slir import slir_fit as jfit
    from meg_decoding_tpu_torch.kamitani.slir import slir_fit

    N, D = (40, 12) if branch == "primal" else (14, 30)
    X, Y = _sparse_problem(N, D, 2, seed=3)
    got = slir_fit(X, Y, prune_mode=prune_mode, device="cpu")
    want = jfit(X, Y, prune_mode=prune_mode)
    if branch == "primal":
        _assert_fit_close(got, want)
    else:
        mask = np.asarray(want[3])
        np.testing.assert_array_equal(got[3].numpy(), mask)
        assert (got[0].numpy()[:, ~mask] == 0).all()
        W1, jW1 = slir_fit(X, Y, n_iter=1, prune_mode=prune_mode, device="cpu")[0], \
            np.asarray(jfit(X, Y, n_iter=1, prune_mode=prune_mode)[0])
        np.testing.assert_allclose(W1.numpy(), jW1, rtol=1e-3,
                                   atol=1e-3 * np.abs(jW1).max())
    if prune_mode > 0:  # the irrelevant features are pruned
        assert 0 < int(got[3].sum()) < D


def _jax_slir_fit_f64():
    """JAX's ``slir_fit`` with float64 as its working type: the module's
    source with ``jnp.float32`` read as ``jnp.float64``, to be called
    under ``jax.enable_x64`` (the package itself is not touched)."""
    import inspect
    import types

    from meg_decoding_tpu.kamitani import slir as jslir

    src = inspect.getsource(jslir).replace("jnp.float32", "jnp.float64")
    mod = types.ModuleType("slir_float64")
    exec(compile(src, jslir.__file__, "exec"), mod.__dict__)
    return mod.slir_fit


@pytest.mark.parametrize("prune_mode", [0, 1, 2])
def test_slir_fit_dual_branch_matches_jax_in_float64(prune_mode):
    import jax

    from meg_decoding_tpu_torch.kamitani.slir import slir_fit

    jfit = _jax_slir_fit_f64()
    X, Y = (a.astype(np.float64) for a in _sparse_problem(14, 30, 2, seed=3))
    for n_iter, w_tol, a_tol, sy_tol in ((1, 1e-11, 1e-11, 1e-11),
                                         (20, 1e-7, 1e-5, 1e-5),
                                         (200, 1e-4, 1e-2, 1e-2)):
        with jax.enable_x64(True):
            want = [np.asarray(t) for t in jfit(X, Y, n_iter=n_iter,
                                                prune_mode=prune_mode)]
        got = [t.numpy() for t in slir_fit(X, Y, n_iter=n_iter,
                                           prune_mode=prune_mode, device="cpu",
                                           dtype=torch.float64)]
        (W, A, SY, mask), (jW, jA, jSY, jmask) = got, want
        msg = f"n_iter={n_iter}"
        assert W.dtype == jW.dtype == np.float64, msg
        np.testing.assert_array_equal(mask, jmask, err_msg=msg)
        np.testing.assert_allclose(W, jW, rtol=0, atol=w_tol * np.abs(jW).max(),
                                   err_msg=msg)
        np.testing.assert_allclose(A, jA, rtol=0, atol=a_tol * np.abs(jA).max(),
                                   err_msg=msg)
        np.testing.assert_allclose(SY, jSY, rtol=sy_tol, err_msg=msg)


@pytest.mark.parametrize("prune_mode", [0, 1])
def test_slir_fit_noise_fallback_matches_jax_in_float64(prune_mode):
    import jax

    from meg_decoding_tpu_torch.kamitani.slir import slir_fit

    jfit = _jax_slir_fit_f64()
    N, D, L = 8192, 32, 2
    rng = np.random.RandomState(0)
    X = 1e-2 * rng.randn(N, D)
    X[:, 0] = rng.choice([-1.0, 1.0], N)
    Y = np.outer(X[:, 0], [1.0, -2.0])  # in the span of X
    SY0 = (Y * Y).mean()
    with jax.enable_x64(True):
        W1 = np.asarray(jfit(X, Y, n_iter=1, prune_mode=prune_mode)[0])
        # the quick estimate the second iteration takes, from JAX's state
        # after the first (the W that iteration computes)
        quick = ((Y * Y).sum() - (W1 * (Y.T @ X)).sum()) / (L * N)
        assert 0 < quick / SY0 < 1e-6, quick / SY0
        for n_iter in (2, 5, 50):
            want = [np.asarray(t) for t in jfit(X, Y, n_iter=n_iter,
                                                prune_mode=prune_mode)]
            got = [t.numpy() for t in slir_fit(X, Y, n_iter=n_iter,
                                               prune_mode=prune_mode,
                                               device="cpu",
                                               dtype=torch.float64)]
            (W, A, SY, mask), (jW, jA, jSY, jmask) = got, want
            msg = f"n_iter={n_iter}"
            assert jSY / SY0 < 1e-6, msg  # the fallback's own, small noise
            np.testing.assert_array_equal(mask, jmask, err_msg=msg)
            np.testing.assert_allclose(W, jW, rtol=0,
                                       atol=1e-12 * np.abs(jW).max(), err_msg=msg)
            np.testing.assert_allclose(A, jA, rtol=0,
                                       atol=1e-8 * np.abs(jA).max(), err_msg=msg)
            np.testing.assert_allclose(SY, jSY, rtol=1e-8, err_msg=msg)


def test_slir_fit_batched_over_units_matches_jax_vmap():
    import jax

    from meg_decoding_tpu.kamitani.slir import slir_fit as jfit
    from meg_decoding_tpu_torch.kamitani.slir import (
        SparseLinearRegression,
        slir_fit,
        slir_predict,
    )

    probs = [_sparse_problem(30, 10, 1, seed=s) for s in range(3)]
    X = np.stack([p[0] for p in probs])
    Y = np.stack([p[1] for p in probs])
    got = slir_fit(X, Y, n_iter=120, device="cpu")
    want = jax.vmap(lambda a, b: jfit(a, b, n_iter=120))(jnp.asarray(X),
                                                        jnp.asarray(Y))
    _assert_fit_close(got, want)
    np.testing.assert_allclose(slir_predict(got[0], X).numpy(),
                               np.asarray(X @ np.swapaxes(np.asarray(want[0]), 1, 2)),
                               rtol=1e-3, atol=1e-4)
    est = SparseLinearRegression(n_iter=120, device="cpu").fit(X[0], Y[0, :, 0])
    assert est.predict(X[0]).shape == (30,)
    np.testing.assert_array_equal(est.valid_index_list,
                                  np.where(np.asarray(want[3][0]))[0])


def _decodable(seed, n_tr=60, n_te=20, V=24, U=6, n_cat=5):
    rng = np.random.RandomState(seed)
    M = rng.randn(V, U)
    cats = rng.randint(0, n_cat, n_tr + n_te)
    protos = rng.randn(n_cat, U)
    Yall = protos[cats] + 0.2 * rng.randn(n_tr + n_te, U)
    Xall = Yall @ np.linalg.pinv(M) + 0.3 * rng.randn(n_tr + n_te, V)
    return (Xall[:n_tr], Yall[:n_tr], Xall[n_tr:], Yall[n_tr:], cats[n_tr:])


def test_feature_prediction_and_identification_match_jax():
    from meg_decoding_tpu.kamitani import pipeline as jp
    from meg_decoding_tpu_torch.kamitani import pipeline as tp

    xtr, ytr, xte, yte, labels = _decodable(1)
    pred, true = tp.feature_prediction(xtr, ytr, xte, yte, n_voxel=16,
                                       n_iter=100, device="cpu")
    jpred, jtrue = jp.feature_prediction(xtr, ytr, xte, yte, n_voxel=16,
                                         n_iter=100)
    np.testing.assert_array_equal(true, jtrue)
    np.testing.assert_allclose(pred, jpred, rtol=1e-3,
                               atol=1e-4 * np.abs(jpred).max())
    avg = tp.get_averaged_feature(pred, true, labels)
    javg = jp.get_averaged_feature(jpred, jtrue, labels)
    np.testing.assert_array_equal(avg[2], javg[2])
    rate = tp.pairwise_identification_rate(avg[0], avg[1], device="cpu")
    jrate = jp.pairwise_identification_rate(javg[0], javg[1])
    np.testing.assert_array_equal(rate, jrate)
    assert rate.mean() > 0.5  # the data are decodable


@pytest.fixture(scope="module")
def god_set(tmp_path_factory):
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    root = str(tmp_path_factory.mktemp("kamitani"))
    cfg = make_synthetic_god_dataset(root, subjects=("sbj01",), n_train=40,
                                     n_test=10, feat_dim=16)
    return root, cfg


def test_kamitani_cli_matches_jax_example(god_set, tmp_path):
    """The CLI end to end on the synthetic GOD set against the JAX
    example's ``run``: the same JSON keys and accuracy."""
    from meg_decoding_tpu.core.config import Config as JConfig
    from meg_decoding_tpu_torch.cli import kamitani_regression
    from meg_decoding_tpu_torch.core.config import Config, to_dict

    _, cfg = god_set
    spec = importlib.util.spec_from_file_location(
        "jax_kamitani_example", os.path.join(ROOT, "examples",
                                             "kamitani_regression.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    d = dict(to_dict(cfg), save_root=str(tmp_path / "jax"))
    jacc, jcat = example.run(JConfig(d), ch_ratios=0.5, n_iter=60)
    d["save_root"] = str(tmp_path / "torch")
    acc, cat = kamitani_regression.run(Config(d), ch_ratios=0.5, n_iter=60,
                                       device="cpu")
    assert acc == jacc and cat == jcat
    with open(tmp_path / "torch" / "kamitani_regression.json") as f:
        got = json.load(f)
    with open(tmp_path / "jax" / "kamitani_regression.json") as f:
        assert got == json.load(f)
    # the module entry point composes the same run
    kamitani_regression.main(["--device", "cpu", "--config-path",
                              str(tmp_path), "--config-name", "k"]
                             if _write_yaml(tmp_path / "k.yaml", d) else [])
    with open(tmp_path / "torch" / "kamitani_regression.json") as f:
        assert set(json.load(f)) == {"acc", "category_wise"}


def _write_yaml(path, d) -> bool:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dict(d, ch_ratios=0.5, slir_n_iter=20), f)
    return True
