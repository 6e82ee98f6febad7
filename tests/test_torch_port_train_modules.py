"""Training modules of the port (meg_decoding_tpu_torch) against their JAX
counterparts on the CPU, at small sizes: BN statistics, the BN backward
(``bn_bwd``) against the JAX custom VJP, the batch-norm autograd function,
the running-statistics update, spatial dropout, the erf_poly GELU
gradient, Adam with its schedules, and checkpoints.

The JAX BatchNorm statistics run their Pallas kernels in interpret mode
(``impl='pallas'``) or as plain XLA reductions (``impl='xla'``); the port's
wrappers take their plain versions because the tensors lie on the CPU.

Tolerances, each with its reason:
* BN sums — rtol 1e-5, atol 1e-4 (as tests/test_batchnorm.py): f32 sums
  taken in another order;
* batch_norm_train forward and backward, and bn_bwd — rtol 2e-4, atol 1e-6
  (as tests/test_batchnorm.py); bf16 — rtol/atol 2e-2, one bf16 rounding
  apart;
* running statistics — rtol 1e-5, the batch statistics' own tolerance;
* spatial-dropout masks — exactly equal;
* erf_poly GELU gradient — rtol 2e-6, atol 1e-6: the same closed form,
  exp and the polynomial within a few f32 ulp;
* Adam — rtol 1e-5, atol 1e-8: the same arithmetic in the same order,
  b^count and the schedule's cos within an ulp.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from meg_decoding_tpu.ops.pallas import batchnorm as jbn
from meg_decoding_tpu_torch.ops.kernels import batchnorm as tbnk

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")
B, T, C = 4, 24, 12


def _to_ncw(a: np.ndarray) -> torch.Tensor:
    """JAX's (B, T, C) → the port's (B, C, T)."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


# --- the two statistics kernels (plain versions here) ----------------------

@pytest.mark.parametrize("M", [7, 1000, 1024])
def test_bn_stats_plain_matches_pallas(M):
    rng = np.random.RandomState(M)
    x = (rng.randn(M, C) * 3 + 1.5).astype(np.float32)
    g = rng.randn(M, C).astype(np.float32)
    s, ss = jbn.bn_stats(jnp.asarray(x), block_rows=256, interpret=True)
    mean = x.mean(0)
    invstd = (1.0 / np.sqrt(x.var(0) + 1e-5)).astype(np.float32)
    sg, sgx = jbn.bn_bwd_stats(jnp.asarray(g), jnp.asarray(x), jnp.asarray(mean),
                               jnp.asarray(invstd), block_rows=256, interpret=True)
    # (M, C) as the port's (1, C, M): the channel on dim 1
    tx = torch.from_numpy(np.ascontiguousarray(x.T[None]))
    tg = torch.from_numpy(np.ascontiguousarray(g.T[None]))
    ts, tss = tbnk.bn_stats(tx)
    tsg, tsgx = tbnk.bn_bwd_stats(tg, tx, torch.from_numpy(mean),
                                  torch.from_numpy(invstd))
    for got, want in ((ts, s), (tss, ss), (tsg, sg), (tsgx, sgx)):
        assert got.dtype == torch.float32 and got.shape == (C,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)


def test_bn_stats_take_bf16_and_sum_in_f32():
    x = torch.randn(3, 5, 40, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16)
    s, ss = tbnk.bn_stats(xb)
    xf = xb.to(torch.float32)
    assert s.dtype == ss.dtype == torch.float32
    torch.testing.assert_close(s, xf.sum((0, 2)))
    torch.testing.assert_close(ss, (xf * xf).sum((0, 2)))


def test_bn_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbnk.bn_stats(torch.zeros(2, 3, 4, device="meta"))
    with pytest.raises(ValueError, match=r"\(B, C, T\)"):
        tbnk.bn_stats(torch.zeros(6, 4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tbnk.bn_stats(x.double())
    with pytest.raises(ValueError, match="differ"):
        tbnk.bn_bwd_stats(x.to(torch.bfloat16), x, torch.zeros(3), torch.ones(3))
    with pytest.raises(ValueError, match="mean"):
        tbnk.bn_bwd_stats(x, x, torch.zeros(4), torch.ones(3))
    tbnk.reset_launches()
    tbnk.bn_stats(x)
    tbnk.bn_bwd_stats(x, x, torch.zeros(3), torch.ones(3))
    assert tbnk.launches == {"bn_stats": 0, "bn_bwd_stats": 0}  # CPU: plain


# --- the BatchNorm backward (bn_bwd's plain version here) -------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cotangents", [False, True])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_bn_bwd_plain_matches_jax_vjp(impl, cotangents, dtype):
    """(dx, Σg, Σg·x̂) against the JAX custom VJP's (dx, dscale, dbias),
    with and without the cotangents of the batch mean and variance."""
    rng = np.random.RandomState(3)
    x = (rng.randn(B, T, C) * 3 + 1.5).astype(np.float32)
    gy = rng.randn(B, T, C).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    gmean, gvar = rng.randn(2, C).astype(np.float32)
    if not cotangents:
        gmean = gvar = np.zeros(C, np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(gy, jdt)
    (_, jm, jv), vjp = jax.vjp(
        lambda a, s, b: jbn.batch_norm_train(a, s, b, 1e-5, impl),
        xj, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jsgx, jsg = vjp((gj, jnp.asarray(gmean), jnp.asarray(gvar)))

    tdt = getattr(torch, dtype)
    mean = torch.from_numpy(np.array(jm))
    invstd = torch.rsqrt(torch.from_numpy(np.array(jv)) + 1e-5)
    cots = ((torch.from_numpy(gmean), torch.from_numpy(gvar)) if cotangents
            else (None, None))
    dx, sg, sgx = tbnk.bn_bwd_plain(
        _to_ncw(np.asarray(gj, np.float32)).to(tdt),
        _to_ncw(np.asarray(xj, np.float32)).to(tdt), torch.from_numpy(scale),
        mean, invstd, *cots)
    assert dx.dtype == tdt and sg.dtype == sgx.dtype == torch.float32
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=1e-6))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.swapaxes(np.asarray(jdx, np.float32), 1, 2),
                               **tol)
    np.testing.assert_allclose(sg.numpy(), np.asarray(jsg), **tol)
    np.testing.assert_allclose(sgx.numpy(), np.asarray(jsgx), **tol)


def test_bn_bwd_on_cpu_is_its_plain_version_and_launches_nothing():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 16, generator=g) * 2 + 1
    gy = torch.randn(3, 4, 16, generator=g)
    scale = torch.rand(4, generator=g) + 0.5
    mean = x.mean((0, 2))
    invstd = torch.rsqrt(x.var((0, 2), correction=0) + 1e-5)
    tbnk.reset_launches()
    for cots in ((None, None), (torch.randn(4, generator=g), None),
                 (None, torch.randn(4, generator=g))):
        got = tbnk.bn_bwd(gy, x, scale, mean, invstd, *cots)
        want = tbnk.bn_bwd_plain(gy, x, scale, mean, invstd, *cots)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    tbnk.bn_bwd_stats(gy, x, mean, invstd)
    assert tbnk.launches == {"bn_stats": 0, "bn_bwd_stats": 0}
    assert tbnk.sums_only_launches == 0
    with pytest.raises(ValueError, match="scale"):
        tbnk.bn_bwd(gy, x, torch.ones(3), mean, invstd)
    with pytest.raises(ValueError, match="gvar"):
        tbnk.bn_bwd(gy, x, scale, mean, invstd, None, torch.zeros(4).double())
    with pytest.raises(ValueError, match="differ"):
        tbnk.bn_bwd(gy.to(torch.bfloat16), x, scale, mean, invstd)


# --- batch_norm_train ------------------------------------------------------

@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_batch_norm_train_matches_jax(impl):
    from meg_decoding_tpu_torch.ops.batchnorm import batch_norm_train

    rng = np.random.RandomState(1)
    x = (rng.randn(B, T, C) * 3 + 1.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    wy, wm, wv = rng.randn(3, C).astype(np.float32)

    def jloss(x, scale, bias):
        y, mean, var = jbn.batch_norm_train(x, scale, bias, 1e-5, impl)
        # nonzero cotangents on all three outputs
        return (jnp.sum(jnp.sin(y) * wy) + jnp.sum(mean * wm)
                + jnp.sum(var * wv)), (y, mean, var)

    (_, (jy, jm, jv)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                               has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    tx = _to_ncw(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    y, mean, var = batch_norm_train(tx, ts, tb, 1e-5)
    loss = ((torch.sin(y) * torch.from_numpy(wy)[:, None]).sum()
            + (mean * torch.from_numpy(wm)).sum()
            + (var * torch.from_numpy(wv)).sum())
    loss.backward()
    tol = dict(rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(y.detach().numpy(),
                               np.swapaxes(np.asarray(jy), 1, 2), **tol)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jm), **tol)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(jv), **tol)
    np.testing.assert_allclose(tx.grad.numpy(),
                               np.swapaxes(np.asarray(jg[0]), 1, 2), **tol)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg[1]), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]), **tol)


def test_batch_norm_train_bf16_matches_jax():
    from meg_decoding_tpu_torch.ops.batchnorm import batch_norm_train

    rng = np.random.RandomState(2)
    x = (rng.randn(B, T, C) * 3 + 1.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    scale, bias = np.ones(C, np.float32), np.zeros(C, np.float32)
    wy = rng.randn(C).astype(np.float32)
    jy, jm, jv = jbn.batch_norm_train(xb, scale, bias, 1e-5, "pallas")
    jdx = jax.grad(lambda a: jnp.sum(
        jbn.batch_norm_train(a, scale, bias, 1e-5, "pallas")[0]
        .astype(jnp.float32) * wy))(xb)

    tx = _to_ncw(x).to(torch.bfloat16).requires_grad_()
    y, mean, var = batch_norm_train(tx, torch.from_numpy(scale),
                                    torch.from_numpy(bias), 1e-5)
    (y.to(torch.float32) * torch.from_numpy(wy)[:, None]).sum().backward()
    assert y.dtype == tx.grad.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(y.detach().float().numpy(),
                               np.swapaxes(np.asarray(jy, np.float32), 1, 2), **tol)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var.detach().numpy(), np.asarray(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.swapaxes(np.asarray(jdx, np.float32), 1, 2),
                               **tol)


def test_fused_batch_norm_running_stats_match_flax():
    """Two training applies: flax's batch_stats against the port's running
    statistics, committed after each forward."""
    from meg_decoding_tpu.models.layers import FusedBatchNorm as JBN
    from meg_decoding_tpu_torch.models.layers import (
        FusedBatchNorm,
        commit_running_stats,
    )

    rng = np.random.RandomState(3)
    xs = [(rng.randn(B, T, C) * s + o).astype(np.float32)
          for s, o in ((3.0, 1.5), (0.5, -2.0))]
    jmod = JBN(use_running_average=False, momentum=0.9, impl="pallas")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    bn = FusedBatchNorm(C, momentum=0.9).train()
    for x in xs:
        jy, upd = jmod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {**variables, "batch_stats": upd["batch_stats"]}
        y = bn(_to_ncw(x))
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.swapaxes(np.asarray(jy), 1, 2),
                                   rtol=2e-4, atol=1e-6)
        commit_running_stats(bn, torch.tensor(True))
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(upd["batch_stats"][k]),
                                       rtol=1e-5)


def test_running_stats_change_only_on_a_committed_finite_step():
    from meg_decoding_tpu_torch.models.layers import (
        FusedBatchNorm,
        commit_running_stats,
    )

    bn = FusedBatchNorm(C, momentum=0.9).train()
    x = torch.randn(B, C, T, generator=torch.Generator().manual_seed(4)) + 3.0
    bn(x)  # a training forward alone writes nothing
    assert torch.equal(bn.mean, torch.zeros(C)) and torch.equal(bn.var, torch.ones(C))
    commit_running_stats(bn, torch.tensor(False))  # a skipped step
    assert torch.equal(bn.mean, torch.zeros(C)) and bn.proposed is None
    commit_running_stats(bn, torch.tensor(True))   # nothing left to commit
    assert torch.equal(bn.mean, torch.zeros(C))
    bn(x)
    commit_running_stats(bn, torch.tensor(True))
    assert float(bn.mean.mean()) == pytest.approx(0.3, abs=0.05)


# --- spatial dropout, GELU -------------------------------------------------

@pytest.mark.parametrize("d_drop", [0.0, 0.1, 0.3])
def test_spatial_dropout_mask_matches_jax(d_drop):
    from meg_decoding_tpu.models.layers import spatial_dropout_mask as jmask
    from meg_decoding_tpu_torch.models.layers import spatial_dropout_mask
    from tests.test_torch_port_modules import _loc

    loc = _loc(20)
    for seed in range(6):
        rng = jax.random.PRNGKey(seed)
        centre = int(jax.random.randint(rng, (), 0, loc.shape[0]))
        want = np.asarray(jmask(rng, jnp.asarray(loc), d_drop))
        got = spatial_dropout_mask(torch.from_numpy(loc), d_drop, centre)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[centre] == (0.0 if d_drop > 0 else 1.0)


def test_erf_poly_gelu_gradient_matches_jax():
    from meg_decoding_tpu.ops.gelu import gelu as jgelu
    from meg_decoding_tpu_torch.ops.gelu import gelu

    x = np.linspace(-6, 6, 4001).astype(np.float32)
    w = np.cos(x).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jgelu(a, "erf_poly") * w))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (gelu(tx, "erf_poly") * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=2e-6, atol=1e-6)


# --- Adam and the schedules ------------------------------------------------

SCHEDULES = {
    "none": {},
    "cosine": {},
    "multistep": {"lr_multistep_mlstns": [0.25, 0.5], "lr_step_gamma": 0.5},
}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_adam_and_schedule_match_optax(kind):
    """Eight updates at 2 per epoch of a 4-epoch schedule; the fourth
    gradient is NaN, which must leave every piece of state unchanged, as
    the JAX step's ``where(ok, new, old)`` does."""
    from meg_decoding_tpu.core.config import Config as JConfig
    from meg_decoding_tpu.train.schedules import make_schedule as jsched
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.interop import adam_state_from_jax
    from meg_decoding_tpu_torch.train.optim import global_norm
    from meg_decoding_tpu_torch.train.schedules import make_optimizer

    conf = {"lr": 3e-3, "epochs": 4, "lr_scheduler": kind, **SCHEDULES[kind]}
    opt = optax.adam(jsched(JConfig(conf), 2))
    rng = np.random.RandomState(5)
    jparams = {"model": {"w": rng.randn(3, 4).astype(np.float32),
                         "b": rng.randn(4).astype(np.float32)},
               "loss": {"temp": np.array(5.1, np.float32)}}
    jstate = opt.init(jparams)
    adam = make_optimizer(Config(conf), 2)
    params = {"w": torch.tensor(jparams["model"]["w"]),
              "b": torch.tensor(jparams["model"]["b"]),
              "loss.temp": torch.tensor(jparams["loss"]["temp"])}
    state = adam.init(params)

    for i in range(8):
        g = {"model": {"w": rng.randn(3, 4).astype(np.float32),
                       "b": rng.randn(4).astype(np.float32)},
             "loss": {"temp": np.array(rng.randn(), np.float32)}}
        if i == 3:
            g["model"]["w"][1, 2] = np.nan
        ok = bool(np.isfinite(optax.global_norm(g)))
        upd, new_state = opt.update(g, jstate, jparams)
        if ok:
            jparams = optax.apply_updates(jparams, upd)
            jstate = new_state
        grads = {"w": torch.tensor(g["model"]["w"]),
                 "b": torch.tensor(g["model"]["b"]),
                 "loss.temp": torch.tensor(g["loss"]["temp"])}
        before = {k: v.clone() for k, v in params.items()}
        t_ok = torch.isfinite(global_norm(grads.values()))
        assert bool(t_ok) == ok
        adam.update(params, grads, state, t_ok)
        if not ok:
            for k in params:
                assert torch.equal(params[k], before[k])
        want = adam_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
        assert int(state.count) == int(want.count) == i + (1 if i < 3 else 0)
        tol = dict(rtol=1e-5, atol=1e-8)
        for k in params:
            np.testing.assert_allclose(
                params[k].numpy(),
                np.asarray(jparams["loss"]["temp"] if k == "loss.temp"
                           else jparams["model"][k]), **tol)
            np.testing.assert_allclose(state.mu[k].numpy(), want.mu[k].numpy(), **tol)
            np.testing.assert_allclose(state.nu[k].numpy(), want.nu[k].numpy(), **tol)


# --- checkpoints -----------------------------------------------------------

def _tiny_state(seed=0):
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from meg_decoding_tpu_torch.train.schedules import make_optimizer
    from meg_decoding_tpu_torch.train.state import create_train_state
    from tests.test_torch_port_modules import _loc

    model = BrainEncoder(_loc(6), 2, D1=4, D2=4, F=4, K=2, num_blocks=1,
                         seq2seq=True, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(Config({"lr": 1e-3, "epochs": 1}), 1)
    return create_train_state(model, opt, seed=seed)


def test_checkpoint_rotation_and_restore_order(tmp_path):
    from meg_decoding_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(str(tmp_path))
    a, b = _tiny_state(0), _tiny_state(1)
    with torch.no_grad():
        a.temp.fill_(1.5)
        a.step.fill_(7)
        a.opt_state.mu["conv0.bn0.scale"].fill_(0.25)
        a.model.conv0.bn0.mean.fill_(3.0)
    a.generator.manual_seed(11)
    ckpt.save("model_last", a)
    assert ckpt.exists("model_last") and not ckpt.exists("model_best")
    restored = ckpt.restore("model_last", b)
    assert float(restored.temp.detach()) == 1.5 and int(restored.step) == 7
    assert float(restored.opt_state.mu["conv0.bn0.scale"][0]) == 0.25
    assert float(restored.model.conv0.bn0.mean[0]) == 3.0
    torch.testing.assert_close(restored.model.state_dict(), a.model.state_dict())
    assert torch.equal(restored.generator.get_state(), a.generator.get_state())
    # a second save keeps the first as .old; a corrupt .new falls back to it
    with torch.no_grad():
        a.step.fill_(8)
    ckpt.save("model_last", a)
    assert (tmp_path / "model_last.old.pt").exists()
    (tmp_path / "model_last.pt").rename(tmp_path / "model_last.new.pt")
    (tmp_path / "model_last.old.pt").rename(tmp_path / "model_last.pt")
    assert int(ckpt.restore("model_last", _tiny_state(2)).step) == 8  # .new first
    (tmp_path / "model_last.new.pt").write_bytes(b"partial")
    with pytest.warns(UserWarning):
        (tmp_path / "model_last.pt").rename(tmp_path / "model_last.old.pt")
        assert int(ckpt.restore("model_last", _tiny_state(2)).step) == 7
    (tmp_path / "model_last.old.pt").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="model_last"):
        ckpt.restore("model_last", _tiny_state(2))


# --- the step profiler's bookkeeping -----------------------------------------

def test_profiler_busy_time_merges_overlapping_kernels():
    from meg_decoding_tpu_torch.cli.profile_train_step import busy_us, kernel_group

    assert busy_us([]) == 0.0
    assert busy_us([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (2.5, 2.8)]) == 5.0
    assert busy_us(((0.0, 10.0), (2.0, 3.0))) == 10.0
    assert kernel_group("void bn_stats_kernel<float>(float const*)") == "bn_statistics"
    assert kernel_group("sm90_xmma_wgrad_implicit_gemm_bf16") == "convolution"
    assert kernel_group("void window_gather_vec_kernel") == "window_gather"
    assert kernel_group("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert kernel_group("something_else") == "other"
