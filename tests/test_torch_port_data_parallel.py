"""The port's data parallelism against the JAX package's mesh, on the CPU.

The port runs one process per rank: each module-scoped group below starts
its ranks once (``tests/torch_dp_worker.py``: gloo over a fresh ``file://``
store, one torch thread, joined with a deadline) and runs every case on
them; the tests then compare each rank's results with JAX run in this
process on the conftest's virtual CPU devices (``make_mesh(n)``).  Both
sides take the same inputs and the same draws: the test makes the data
with numpy and recomputes JAX's per-device session draws
(``fold_in(key, d)``) for the port.  The encoders run with ``d_drop = 0``.

Tolerances, each with its reason:
* the sharded CLIP loss, its gradients (x, y, temp) and the synced BN
  against JAX and against the unsharded loss — rtol 1e-5 (f32 sums in
  another order), and an absolute 1e-6 · max|ref| for entries near zero;
  top-1 / top-10 exactly;
* ``pad_sessions``, the device-major draw, the sharded gather and the
  spilled loader against the sharded one — bit-exact (the same copies);
* the shard's collate-stats table — the single-device port's table of the
  padded sessions bit-exact, JAX's within 2 ulp (the percentiles' test);
* two DP train steps (speech fused, GOD with the same-label term) —
  the single-device trajectory tests' bounds
  (``tests/test_torch_port_train_slice.py``): loss rtol 1e-3, parameters
  rtol 1e-4 / atol 1e-5, and 2·n·lr for the entries whose gradient is
  rounding noise (ROADMAP Queue 3);
* the DP train CLI — both ranks' parameters bit-identical (one gradient
  all-reduce, one optimizer arithmetic).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_train_slice import (
    _assert_close_after_training,
    _cli_cfg,
    _collate_cfgs,
    train_setup,  # noqa: F401
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D1, D2, K, NB, LR, TEMP0 = 16, 24, 4, 2, 1e-3, 5.1
B_SPEECH, B_GOD, B_CLIP = 16, 8, 8
DEADLINE_S = 240
SCHED = {"lr": LR, "epochs": 4, "lr_scheduler": "cosine"}
ALL_CASES = ("clip", "bn", "gather", "spill", "speech", "god", "cli",
             "resume")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(n):
    from meg_decoding_tpu.core.mesh import make_mesh

    return make_mesh(n_data=n, devices=jax.devices("cpu")[:n])


def _local_draws(key, n, s_local, b):
    """JAX's session draw inside ``local_shard_gather``: device d draws
    b/n shard-local sessions from ``fold_in(key, d)``."""
    return np.concatenate([
        np.asarray(jax.random.randint(jax.random.fold_in(key, d), (b // n,), 0,
                                      s_local)) for d in range(n)])


def _inputs(s, tmp):
    """Every case's inputs (numpy, made from seeds), and the JAX side of
    the train-step cases."""
    from meg_decoding_tpu.core.config import Config as JConfig
    from meg_decoding_tpu.data.gwilliams import _gather_batch as jgather
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_fused_speech_step as jfused
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_train_step as jtrain_step
    from meg_decoding_tpu_torch.core.config import to_dict

    rng = np.random.RandomState(0)
    x3 = rng.randn(B_CLIP, 4, 6).astype(np.float32)
    x2 = rng.randn(B_CLIP, 24).astype(np.float32)
    clip = {"3d": (x3, (x3 + 2.5 * rng.randn(*x3.shape)).astype(np.float32), 0.7),
            "2d": (x2, (x2 + 1.5 * rng.randn(*x2.shape)).astype(np.float32), 1.3)}
    bn = {k: rng.randn(*shape).astype(np.float32) for k, shape in (
        ("x", (B_CLIP, 6, 10)), ("g", (B_CLIP, 6, 10)), ("cm", (6,)),
        ("cv", (6,)))}
    bn["x"] = bn["x"] * 3.0 + 1.5
    bn["scale"] = (1.0 + 0.3 * rng.randn(6)).astype(np.float32)
    bn["bias"] = (0.2 * rng.randn(6)).astype(np.float32)

    jds = s["j_tr"]
    jcol, tcol = _collate_cfgs(s["cfg"])
    S = int(jds.recordings.shape[0])
    s_local = -(-S // 2)
    gkey = jax.random.PRNGKey(11)
    gidx = rng.randint(0, len(s["t_tr"]), B_SPEECH)
    gather = {"idx": gidx, "key": gkey, "baseline": 0,
              "sess": _local_draws(gkey, 2, s_local, B_SPEECH)}

    # the speech model and its JAX DP trajectory (2 fused steps)
    jm = JEnc(loc=s["loc"], num_subjects=3, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=True, num_blocks=NB)
    seg = jds.segment_table()[:4]
    example = jgather(jds.recordings, jds.y_stream, jds.meg_onsets,
                      jds.speech_onsets, jds.session_subject,
                      jnp.asarray(seg[:, 0]), jnp.asarray(seg[:, 1]),
                      jnp.zeros(4, jnp.int32), jds.seq_len)
    jo = jopt(JConfig(SCHED), 3)
    js = jstate(jm, jo, example, jax.random.PRNGKey(0), init_temperature=TEMP0)
    init = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    jstep = jfused(jm, jo, JLoss(), jcol, jds, mesh=_jmesh(2),
                   cache_collate_stats=True)
    steps, jmets = [], []
    for i in range(2):
        idx = rng.randint(0, len(s["t_tr"]), B_SPEECH)
        key = jax.random.PRNGKey(100 + i)
        js, jmet = jstep(js, jnp.asarray(idx), key)
        jmets.append({k: float(v) for k, v in jmet.items()})
        steps.append((idx, _local_draws(key, 2, s_local, B_SPEECH)))
    speech = {"loc": s["loc"], "init": {k: v.numpy() for k, v in init.items()},
              "sched": SCHED, "updates_per_epoch": 3, "temp0": TEMP0,
              "model": dict(num_subjects=3, D1=D1, D2=D2, F=16, K=K,
                            d_drop=0.0, seq2seq=True, num_blocks=NB),
              "collate": dict(baseline_len_samp=tcol.baseline_len_samp,
                              clamp_lim=tcol.clamp_lim),
              "cache_stats": True, "steps": steps}
    j_speech = (jmets, params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats})))

    # the GOD-shaped step with the same-label term (2 steps, mean-pooled)
    from meg_decoding_tpu.core.mesh import shard_batch as jshard

    gm = JEnc(loc=s["loc"], num_subjects=2, D1=D1, D2=D2, F=16, K=K,
              d_drop=0.0, seq2seq=False, num_blocks=NB)
    god_batches = [(rng.randn(B_GOD, 12, 24).astype(np.float32),
                    rng.randn(B_GOD, 16).astype(np.float32),
                    rng.randint(0, 2, B_GOD).astype(np.int64),
                    np.array([1, 2, 1, 3, 2, 4, 1, 5], np.int64))
                   for _ in range(2)]
    gj = jstate(gm, jo, tuple(jnp.asarray(a) for a in god_batches[0][:3]),
                jax.random.PRNGKey(1), init_temperature=TEMP0)
    ginit = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": gj.params, "batch_stats": gj.batch_stats}))
    gcol = dict(baseline_len_samp=4, clamp_lim=20.0)
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate

    jmesh = _jmesh(2)
    gstep = jtrain_step(gm, jo, JLoss(same_label_weight=0.5), JCollate(**gcol),
                        donate=False, mesh=jmesh)
    gmets = []
    for b in god_batches:
        gj, jmet = gstep(gj, *jshard(jmesh, tuple(jnp.asarray(a) for a in b)))
        gmets.append({k: float(v) for k, v in jmet.items()})
    god = {"loc": s["loc"], "init": {k: v.numpy() for k, v in ginit.items()},
           "sched": SCHED, "updates_per_epoch": 3, "temp0": TEMP0,
           "model": dict(num_subjects=2, D1=D1, D2=D2, F=16, K=K, d_drop=0.0,
                         seq2seq=False, num_blocks=NB),
           "collate": gcol, "loss": {"same_label_weight": 0.5},
           "steps": god_batches}
    j_god = (gmets, params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": gj.params, "batch_stats": gj.batch_stats})))

    cli_cfg = to_dict(_cli_cfg(s, tmp, epochs=1, run_name="dp", test_size=4))
    cli = {"cfg": cli_cfg, "save_roots": [str(tmp / "out0"), str(tmp / "out1")],
           "resume_root": str(tmp / "resume")}
    inputs = {"clip": clip, "bn": bn, "gather": gather, "speech": speech,
              "god": god, "cli": cli, "speech_cfg": to_dict(s["cfg"])}
    inputs["gather"] = {k: v for k, v in gather.items() if k != "key"}
    return inputs, {"speech": j_speech, "god": j_god, "gather": gather}


def _start(world, cases, in_path, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dp_worker", str(r), str(world),
         store, in_path, out_dir, *cases], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]


def _join(procs, out_dir):
    """Wait for every rank until the deadline; a hung rendezvous or a
    failed rank fails here with the ranks' output."""
    deadline = time.monotonic() + DEADLINE_S
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0]
        logs.append(out.decode(errors="replace"))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n---\n".join(logs))
    return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def dp(train_setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    inputs, jax_side = _inputs(train_setup, tmp)
    in_path = str(tmp / "inputs.pt")
    torch.save(inputs, in_path)
    two = _start(2, ALL_CASES, in_path, str(tmp / "n2"))
    four = _start(4, ("clip", "bn"), in_path, str(tmp / "n4"))
    return {2: _join(two, str(tmp / "n2")), 4: _join(four, str(tmp / "n4")),
            "inputs": inputs, "jax": jax_side, "tmp": tmp}


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-6 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["factored", "normalized"])
@pytest.mark.parametrize("shape", ["3d", "2d"])
def test_sharded_clip_loss_matches_jax(dp, n, impl, shape):
    from meg_decoding_tpu.objectives.clip import clip_loss, clip_loss_sharded

    x, y, temp = dp["inputs"]["clip"][shape]
    ranks = [r["clip"][f"{shape}/{impl}"] for r in dp[n]]

    def jloss(x, y, t):
        return clip_loss_sharded(x, y, t, _jmesh(n), top_ks=(1, 10), impl=impl)

    (jl, jmet), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y), jnp.float32(temp))
    ul, ug = jax.value_and_grad(
        lambda a, b, t: clip_loss(a, b, t, impl=impl), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(y), jnp.float32(temp))
    gx = np.concatenate([r["gx"] for r in ranks])
    gy = np.concatenate([r["gy"] for r in ranks])
    gt = sum(r["gt"] for r in ranks)
    for want_l, want_g in ((jl, jg), (ul, ug)):
        for r in ranks:
            _close(r["loss"], want_l)
        _close(gx, want_g[0])
        _close(gy, want_g[1])
        _close(gt, want_g[2])
    for r in ranks:
        assert r["top1"] == float(jmet["top1"]) and r["top10"] == float(jmet["top10"])
    assert 0.0 < float(jmet["top1"]) < 1.0  # the data ranks some rows wrong
    if impl == "factored":  # the both-gather baseline, once per shape
        for r in dp[n]:
            _close(r["clip"][f"{shape}/gathered"], ul)


@pytest.mark.parametrize("n", [2, 4])
def test_synced_batch_norm_matches_jax_on_the_global_batch(dp, n):
    """Forward and backward (with cotangents of y, the mean and the var)
    against JAX's XLA ``batch_norm_train`` over the whole batch; the scale
    and bias gradients are each rank's sums, summed by the trainer."""
    from meg_decoding_tpu.ops.pallas import batchnorm as jbn

    b = dp["inputs"]["bn"]
    to_btc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 1)))
    (y, mean, var), vjp = jax.vjp(
        lambda x, s, c: jbn.batch_norm_train(x, s, c, 1e-5, "xla"),
        to_btc(b["x"]), jnp.asarray(b["scale"]), jnp.asarray(b["bias"]))
    dx, dscale, dbias = vjp((to_btc(b["g"]), jnp.asarray(b["cm"]),
                             jnp.asarray(b["cv"])))
    ranks = [r["bn"] for r in dp[n]]
    _close(np.concatenate([r["y"] for r in ranks]),
           np.transpose(np.asarray(y), (0, 2, 1)))
    _close(np.concatenate([r["dx"] for r in ranks]),
           np.transpose(np.asarray(dx), (0, 2, 1)))
    for r in ranks:
        _close(r["mean"], mean)
        _close(r["var"], var)
    _close(sum(r["dscale"] for r in ranks), dscale)
    _close(sum(r["dbias"] for r in ranks), dbias)


def test_pad_sessions_and_device_major_draw_match_jax(dp, train_setup):
    from meg_decoding_tpu.data.gwilliams import device_major_sessions as jdm
    from meg_decoding_tpu.data.gwilliams import pad_sessions as jpad
    from meg_decoding_tpu_torch.data.gwilliams import device_major_sessions

    jp = jpad(train_setup["j_tr"], 2)
    got = dp[2][0]["gather"]
    assert got["padded_recordings"].shape[0] == 4  # 3 sessions → 4
    np.testing.assert_array_equal(got["padded_recordings"], np.asarray(jp.recordings))
    np.testing.assert_array_equal(got["padded_subjects"],
                                  np.asarray(jp.session_subject))
    g = dp["jax"]["gather"]
    np.testing.assert_array_equal(
        device_major_sessions(g["sess"], 2, 3),
        np.asarray(jdm(g["key"], 2, 3, B_SPEECH)))


def test_local_shard_gather_matches_jax(dp, train_setup):
    from meg_decoding_tpu.train.scan_loop import _make_sharded_gather as jsg
    from meg_decoding_tpu.train.scan_loop import _shard_gwilliams

    g = dp["jax"]["gather"]
    jmesh = _jmesh(2)
    jds = _shard_gwilliams(train_setup["j_tr"], jmesh)
    X, Y, subs = jax.jit(jsg(jmesh, int(jds.seq_len)))(
        jnp.asarray(g["idx"]), g["key"], jnp.asarray(jds.segment_table()),
        jds.recordings, jds.meg_onsets, jds.y_stream, jds.speech_onsets,
        jds.session_subject)
    b = B_SPEECH // 2
    for r, out in enumerate(dp[2]):
        got = out["gather"]
        assert got["aliased"]  # the two splits share one sharded copy
        rows = slice(r * b, (r + 1) * b)
        np.testing.assert_array_equal(got["X"], np.asarray(X)[rows])
        np.testing.assert_array_equal(got["Y"], np.asarray(Y)[rows])
        np.testing.assert_array_equal(got["subs"], np.asarray(subs)[rows])


def test_sharded_collate_stats_table_matches_jax(dp, train_setup):
    from meg_decoding_tpu.data.gwilliams import compute_collate_stats as jstats
    from meg_decoding_tpu.data.gwilliams import stats_lane_pad
    from meg_decoding_tpu.train.scan_loop import _shard_gwilliams
    from meg_decoding_tpu_torch.data.gwilliams import (
        compute_collate_stats,
        pad_sessions,
    )
    from tests.test_torch_port_collate_stats import _ulps

    ds = pad_sessions(train_setup["t_tr"], 2)
    whole = compute_collate_stats(ds, 0).numpy()
    jmesh = _jmesh(2)
    jt = np.asarray(jstats(_shard_gwilliams(train_setup["j_tr"], jmesh), 0,
                           mesh=jmesh))
    S, NT, C, _ = ds.recordings.shape
    W = int(ds.meg_onsets.shape[2])
    rows = S // 2 * NT * W
    per_shard = jt.shape[0] // 2  # each shard's sweep is chunk-padded
    Cp = stats_lane_pad(C)
    for r, out in enumerate(dp[2]):
        got = out["gather"]["stats"]
        np.testing.assert_array_equal(got, whole[r * rows:(r + 1) * rows])
        blk = jt[r * per_shard:r * per_shard + rows]
        want = np.concatenate([blk[:, :C], blk[:, Cp:Cp + C]], axis=1)
        assert _ulps(got, want) <= 2


@pytest.mark.parametrize("n", [B_SPEECH, 1], ids=["sharded", "whole"])
def test_spilled_loader_under_dp_matches_the_sharded_loader(dp, n):
    """The spilled split replays the session-sharded run's draw: this
    rank's rows of a global batch, and a batch too small to split given
    whole on every rank, bit for bit."""
    for out in dp[2]:
        for a, b in out["spill"][n]:
            np.testing.assert_array_equal(a, b)
    if n == 1:
        x0, x1 = (out["spill"][1][0][0] for out in dp[2])
        assert x0.shape[0] == 1
        np.testing.assert_array_equal(x0, x1)


def _assert_trajectory(ranks, jmets, jstate):
    for out in ranks:
        for met, jmet in zip(out["metrics"], jmets):
            assert met["skipped"] == jmet["skipped"] == 0.0
            np.testing.assert_allclose(met["loss"], jmet["loss"], rtol=1e-3)
            np.testing.assert_allclose(met["temp"], jmet["temp"], rtol=1e-4)
        assert out["metrics"][0]["top1"] == jmets[0]["top1"]
        assert out["metrics"][0]["top10"] == jmets[0]["top10"]
        got = {k: torch.from_numpy(np.asarray(v)) for k, v in out["state"].items()}
        _assert_close_after_training(got, jstate, len(jmets))
    for k, v in ranks[0]["state"].items():  # every rank holds the same copy
        np.testing.assert_array_equal(v, ranks[1]["state"][k], err_msg=k)


def test_fused_speech_dp_steps_match_jax_mesh(dp):
    jmets, jstate = dp["jax"]["speech"]
    _assert_trajectory([r["speech"] for r in dp[2]], jmets, jstate)


def test_god_dp_steps_with_same_label_term_match_jax_mesh(dp):
    jmets, jstate = dp["jax"]["god"]
    _assert_trajectory([r["god"] for r in dp[2]], jmets, jstate)


def test_train_speech_cli_with_a_distributed_block(dp):
    """One epoch of the train CLI in the 2-rank group: rank 0 alone writes
    (its log row, its checkpoints), rank 1's save_root stays empty, and
    both ranks end with the same parameters."""
    r0, r1 = (r["cli"] for r in dp[2])
    out0, out1 = dp["inputs"]["cli"]["save_roots"]
    assert os.listdir(out1) == []
    with open(os.path.join(out0, "runs", "dp", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 1 and rows[0]["train_skipped"] == 0.0
    assert np.isfinite(rows[0]["train_loss"]) and np.isfinite(rows[0]["test_loss"])
    assert os.path.exists(os.path.join(out0, "ckpt", "model_last.pt"))
    assert r0["best"]["test_top10"] == r1["best"]["test_top10"]
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(v, r1["state"][k], err_msg=k)


def test_train_cli_scan_epochs_resume_in_the_group(dp):
    """The whole-epoch form under the mesh, then a resumed run: every
    rank reads rank 0's checkpoint, the log holds epochs 0 and 1, and the
    ranks end on the same step with the same parameters."""
    from tests.test_torch_port_train_slice import _logged_epochs

    r0, r1 = (r["resume"] for r in dp[2])
    epochs, rows = _logged_epochs(dp["inputs"]["cli"]["resume_root"])
    assert epochs == [0, 1]
    assert all(r["train_skipped"] == 0.0 for r in rows)
    assert r0["step"] == r1["step"] == 2 * 3  # updates=3 an epoch
    for k, v in r0["state"].items():
        np.testing.assert_array_equal(v, r1["state"][k], err_msg=k)


def test_train_speech_nproc_launches_one_group(train_setup, tmp_path, monkeypatch):
    """The CLI's own launch, as it starts one rank a GPU when more than
    one is visible (``wants_launch`` made to say 2 here, on the CPU): two
    ranks of one group, one log row an epoch, a checkpoint, and nothing
    trained in the launching process."""
    import yaml

    from meg_decoding_tpu_torch.cli import train_speech
    from meg_decoding_tpu_torch.core.config import to_dict
    from meg_decoding_tpu_torch.parallel import dp as dp_mod

    cfg = to_dict(_cli_cfg(train_setup, tmp_path, epochs=1, run_name="np",
                           test_size=4))
    with open(tmp_path / "dp.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    launch = dp_mod.launch_ranks
    calls = []

    def launch_with_deadline(module, argv, n):
        calls.append(n)
        return launch(module, argv, n, timeout_s=DEADLINE_S)

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(dp_mod, "wants_launch", lambda cfg, device: 2)
    monkeypatch.setattr(dp_mod, "launch_ranks", launch_with_deadline)
    assert train_speech.main(["--device", "cpu", "--config-path", str(tmp_path),
                              "--config-name", "dp"]) == {}
    assert calls == [2]
    with open(tmp_path / "out" / "runs" / "np" / "metrics.jsonl") as f:
        assert len(f.readlines()) == 1
    assert (tmp_path / "out" / "ckpt" / "model_last.pt").exists()


def test_launch_decision(monkeypatch):
    """More than one visible GPU, no group, data_parallel on: the CLI
    starts one process per GPU; otherwise it trains in its own process."""
    from meg_decoding_tpu_torch.core.config import Config
    from meg_decoding_tpu_torch.parallel.dp import wants_launch

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert wants_launch(Config({}), "cuda") == 4
    assert wants_launch(Config({"data_parallel": False}), "cuda") == 0
    assert wants_launch(Config({"distributed": {"num_processes": 4}}), "cuda") == 0
    assert wants_launch(Config({}), "cpu") == 0
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert wants_launch(Config({}), "cuda") == 0
