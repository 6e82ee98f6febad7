"""The port's benchmark (``bench_torch.py`` → ``meg_decoding_tpu_torch/cli/bench.py``)
against the JAX package's ``bench.py``, on the CPU.

``bench.py`` is loaded from its file, as ``tests/test_bench.py`` loads it.

* Every row: ``bench_torch.py --tiny --device cpu`` exits 0 with one JSON
  line holding every key ``tests/test_bench.py`` asks of ``bench.py``
  (MFU null on the CPU, no ``_error`` key).
* No card: without ``--device cpu`` it prints one error row and returns 1,
  with no ``last_measured`` (that file holds a TPU number).
* Only an out-of-memory error becomes a ``_skipped`` row; any other error
  ends the run.
* The FLOP count, memory estimate and capacity pre-check equal
  ``bench.py``'s exactly; the packed set equals ``_make_synthetic_packed``'s
  apart from the random values.
* The bench's step sequence equals ``bench.py``'s: JAX's packed arrays and
  init in the port, the same idx draws (``RandomState(0)``, as
  ``_time_steps`` makes them) and JAX's session draws handed to the port,
  d_drop = 0 on both sides (flax's dropout key cannot be reproduced).
  Tolerances: the loss at every step rtol 1e-3, as
  ``test_torch_port_train_slice.py`` holds the fused step's trajectory
  (the convolutions, BN sums and CLIP logits accumulate in another order,
  and each step's difference carries into the next); one eval pool's loss
  rtol 1e-4 (one forward, no update).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from meg_decoding_tpu_torch.cli import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's --tiny dims
TINY = dict(B=8, C=12, F=16, D1=8, D2=12, K=4, S=2, n_sessions=2,
            rec_sec=30.0, words=24)
TINY_ARGS = ["--tiny", "--device", "cpu", "--steps", "2", "--windows", "2"]


@pytest.fixture(scope="module")
def bench_py():
    spec = importlib.util.spec_from_file_location(
        "benchmod", os.path.join(REPO, "bench.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


@pytest.fixture(scope="module", autouse=True)
def tiny_run():
    """``bench_torch.py --tiny --device cpu`` in its own process, started
    before this module's first test and read by the last one, so that it
    runs beside the JAX tests.  Both it and this module's torch work use
    one intra-op thread: the suite runs several test files at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), *TINY_ARGS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    yield proc
    torch.set_num_threads(n)
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _jax_packed(bench_py):
    t = TINY
    return bench_py._make_synthetic_packed(
        C=t["C"], F=t["F"], rate=120, rec_sec=t["rec_sec"],
        words_per_task=t["words"], n_subjects=t["S"],
        n_sessions=t["n_sessions"], seq_len_sec=3)


def test_no_card_prints_an_error_row(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--tiny"]) == 1
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["value"] == 0.0 and "device='cpu'" in row["error"]
    assert "last_measured" not in row


@pytest.mark.parametrize("error", ["oom", "other"])
def test_only_out_of_memory_becomes_a_skipped_row(monkeypatch, capsys, error):
    def sweep(*args, **kwargs):
        if error == "oom":
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 720.00 MiB")
        raise ValueError("a fault that is not about memory")

    def one_step(step, n_segments, batch, n_steps, n_windows, rng, sync):
        # each timed row runs its first step alone, at a made-up second
        return [1.0] * n_windows, [step(rng.randint(0, n_segments, batch), 1)]

    monkeypatch.setattr(bench, "compute_collate_stats", sweep)
    monkeypatch.setattr(bench, "time_steps", one_step)
    monkeypatch.setattr(bench, "EPOCH_UPDATES", 2)
    monkeypatch.setattr(bench, "EVAL_POOLS", 1)
    args = [*TINY_ARGS[:3], "--steps", "1", "--windows", "1"]
    if error == "other":
        with pytest.raises(ValueError, match="not about memory"):
            bench.main(args)
        assert "bf16_samples_per_sec" in capsys.readouterr().err
        return
    assert bench.main(args) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["collate_stats_sweep_retry"] == "oom_at_runtime"
    assert row["collate_stats_sweep_skipped"] == "oom_at_runtime"
    assert "cached_stats_samples_per_sec" not in row
    # the B = 256 cached rows sweep too: skipped, the rows after them run
    for key in ("b16_bf16_cached_stats", "b16_bf16_cached_stats_gelu_tanh"):
        assert row[f"{key}_skipped"] == "oom_at_runtime"
        assert f"{key}_samples_per_sec" not in row
    assert row["value"] > 0 and row["sentence_split_full_scale_ok"] is True
    assert row["b16_samples_per_sec"] > 0


def test_counts_and_precheck_equal_bench_py(bench_py):
    m = bench_py
    for B in (8, 64, 256, 512, 1024):
        for dims in ((208, 360, 270, 320, 1024), (12, 360, 8, 12, 16)):
            C, T, D1, D2, F = dims
            K = 32 if C == 208 else 4
            assert bench.analytic_step_flops(B, C, T, D1, D2, F, K) \
                == m._analytic_step_flops(B, C, T, D1, D2, F, K)
            for db in (2, 4):
                assert bench.estimate_step_hbm_gb(B, C, T, D1, D2, F, db) \
                    == m._estimate_step_hbm_gb(B, C, T, D1, D2, F, db)
    # a B = 64 step is 0.999 TFLOP at full width
    assert abs(bench.analytic_step_flops(64, 208, 360, 270, 320, 1024, 32)
               / 1e12 - 0.999) < 1e-3

    # tests/test_bench.py::test_capacity_precheck_skips_doomed_rows
    resident, budget = 9.34 + 0.3, 13.5
    skips = {(bx, db): bench.precheck(resident, budget, bx, 208, 360, 270,
                                      320, 1024, db)[1]
             for bx in (256, 512, 1024) for db in (2, 4)}
    assert skips == {(256, 4): False, (256, 2): False, (512, 2): False,
                     (512, 4): True, (1024, 2): True, (1024, 4): True}
    for (bx, db), skip in skips.items():
        est = resident + m._estimate_step_hbm_gb(bx, 208, 360, 270, 320,
                                                 1024, db)
        assert skip == (est > budget)

    assert bench.oom_skip_reason(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) == "oom_at_runtime"
    assert bench.oom_skip_reason(
        RuntimeError("CUDA error: out of memory")) == "oom_at_runtime"
    assert bench.oom_skip_reason(RuntimeError(
        "CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)")) \
        == "oom_at_runtime"
    assert bench.oom_skip_reason(RuntimeError("Broken pipe")) is None
    assert bench.oom_skip_reason(ValueError("allocation of a shape")) is None
    # an error raised while an out-of-memory error unwound (a capture
    # ended by its context manager) is that out-of-memory error
    try:
        try:
            raise torch.OutOfMemoryError("CUDA out of memory")
        except torch.OutOfMemoryError:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")
    except RuntimeError as e:
        assert bench.oom_skip_reason(e) == "oom_at_runtime"


def test_packed_set_equals_bench_py_apart_from_values(bench_py):
    jp = _jax_packed(bench_py)
    t = TINY
    tp = bench.make_synthetic_packed(
        C=t["C"], F=t["F"], rate=120, rec_sec=t["rec_sec"],
        words_per_task=t["words"], n_subjects=t["S"],
        n_sessions=t["n_sessions"], seq_len_sec=3, device="cpu")
    assert tuple(tp.recordings.shape) == tuple(jp.recordings.shape)
    assert tuple(tp.y_stream.shape) == tuple(jp.y_stream.shape)
    assert tp.recordings.shape[-1] == 4224  # Tp: 3,600 samples padded
    assert tp.recordings.dtype == tp.y_stream.dtype == torch.float32
    for name in ("meg_onsets", "speech_onsets", "session_subject"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    np.testing.assert_array_equal(tp.n_words, jp.n_words)
    assert (tp.seq_len, tp.num_subjects) == (jp.seq_len, jp.num_subjects)
    assert len(tp) == len(jp)
    # standard normal draws of its own
    assert abs(float(tp.recordings.mean())) < 0.01
    assert abs(float(tp.recordings.std()) - 1.0) < 0.01


def _port_packed(jp):
    from meg_decoding_tpu_torch.data.gwilliams import GwilliamsPacked

    host = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return GwilliamsPacked(
        recordings=host(jp.recordings), y_stream=host(jp.y_stream),
        meg_onsets=host(jp.meg_onsets), speech_onsets=host(jp.speech_onsets),
        n_words=np.asarray(jp.n_words),
        session_subject=host(jp.session_subject).long(),
        seq_len=jp.seq_len, num_subjects=jp.num_subjects)


def _port_model(loc, sd):
    t = TINY
    model = bench.make_model(loc, t["S"], t["D1"], t["D2"], t["F"], t["K"],
                             None, False, torch.device("cpu"))
    model.subject_block.spatial_attention.d_drop = 0.0
    with torch.no_grad():
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.startswith("loss.")})
    return model


def test_step_sequence_and_eval_pool_match_bench_py(bench_py):
    import optax

    from meg_decoding_tpu.data.gwilliams import gather_speech_batch as jgather
    from meg_decoding_tpu.models.brain_encoder import BrainEncoder as JEnc
    from meg_decoding_tpu.train.scan_loop import make_fused_speech_step as jfused
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu.train.steps import CollateConfig as JCollate
    from meg_decoding_tpu.train.steps import LossConfig as JLoss
    from meg_decoding_tpu.train.steps import make_eval_step as jeval
    from meg_decoding_tpu_torch.data.gwilliams import gather_speech_batch
    from meg_decoding_tpu_torch.data.layout import (
        normalize_locations,
        synthetic_cap_locations,
    )
    from meg_decoding_tpu_torch.interop import params_from_jax

    t = TINY
    B, steps = t["B"], 2
    jp = _jax_packed(bench_py)
    packed = _port_packed(jp)
    loc = normalize_locations(synthetic_cap_locations(t["C"]))
    # bench.py's model, optimizer and configs (bench.py:265-282)
    jm = JEnc(loc=loc, num_subjects=t["S"], D1=t["D1"], D2=t["D2"],
              F=t["F"], K=t["K"], seq2seq=True, dtype=None, d_drop=0.0)
    optimizer = optax.adam(3e-4)
    jloss, jcol = JLoss(kind="clip"), JCollate(baseline_len_samp=60,
                                               clamp_lim=20.0)
    example = (jnp.zeros((B, t["C"], jp.seq_len)),
               jnp.zeros((B, t["F"], jp.seq_len)), jnp.zeros((B,), jnp.int32))
    js = jstate(jm, optimizer, example, jax.random.PRNGKey(0))
    # converted before the fused step donates the state's buffers
    sd = params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}))
    fused = jfused(jm, optimizer, jloss, jcol, jp)

    want = []

    def recording(state, idx, key):
        state, m = fused(state, idx, key)
        want.append((np.array(idx), float(m["loss"])))
        return state, m

    bench_py._time_steps(recording, js, jp, B, n_steps=steps, n_windows=1,
                         rng=np.random.RandomState(0))

    def sessions(i, n):
        # the draw JAX's fused step and gather make from PRNGKey(i)
        return np.array(jax.random.randint(jax.random.PRNGKey(i), (n,), 0,
                                           packed.num_sessions))

    _, step = bench.train_route(_port_model(loc, sd), packed)
    got_idx = []

    def run(idx, i):
        got_idx.append(np.array(idx))
        return step(idx, sess_ids=sessions(i, len(idx)))

    windows, history = bench.time_steps(run, len(packed), B, steps, 1,
                                        np.random.RandomState(0), lambda: None)
    assert len(windows) == 1 and len(history) == len(want) == 4 + steps
    for k, ((idx, loss), got, m) in enumerate(zip(want, got_idx, history)):
        np.testing.assert_array_equal(got, idx)
        assert float(m["skipped"]) == 0.0
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-3,
                                   err_msg=f"step {k + 1}")

    # one eval pool from the same init, as bench.py scores it (:433-437)
    st_eval = jstate(jm, optimizer, example, jax.random.PRNGKey(0))
    idx = np.random.RandomState(1).randint(0, len(packed), B)
    X, Y, subs, _ = jgather(jp, idx, jax.random.PRNGKey(10))
    jm_, _ = jeval(jm, jloss, jcol)(st_eval.params, st_eval.batch_stats,
                                    X, Y, subs)
    model = _port_model(loc, sd)
    state, _ = bench.train_route(model, packed)
    tX, tY, tsubs, _ = gather_speech_batch(packed, idx,
                                           sess_ids=sessions(10, B))
    np.testing.assert_array_equal(tX.numpy(), np.asarray(X))
    got = bench.eval_route(model, state)(tX, tY, tsubs)
    np.testing.assert_allclose(float(got["loss"]), float(jm_["loss"]),
                               rtol=1e-4)


# last: the tiny run has had the module's other tests to finish
def test_tiny_run_emits_every_row(tiny_run):
    out, err = tiny_run.communicate(timeout=300)
    assert tiny_run.returncode == 0, err[-3000:]
    lines = out.strip().splitlines()
    assert len(lines) == 1, out
    row = json.loads(lines[0])
    assert row["metric"] == "gwilliams_train_samples_per_sec_per_chip"
    assert row["value"] > 0 and "error" not in row
    assert not [k for k in row if k.endswith(("_error", "_skipped"))]
    # tests/test_bench.py's keys; tiny mode's batch rows are b16_*
    for key in ["scan_epoch_samples_per_sec", "bf16_samples_per_sec",
                "scan_epoch_promoted_samples_per_sec",
                "b16_bf16_samples_per_sec",
                "b16_bf16_cached_stats_samples_per_sec",
                "b16_bf16_cached_stats_gelu_tanh_samples_per_sec",
                "collate_stats_sweep_sec", "eval_ms_per_pool",
                "sentence_split_full_scale_ok", "vs_baseline_1thread"]:
        assert key in row, key
    assert row["scale"] == "tiny" and row["device"] == "cpu"
    assert row["sentence_split_full_scale_ok"] is True
    assert len(row["sec_per_step_windows"]) == 2
    assert row["sec_per_step"] == min(row["sec_per_step_windows"])
    mfus = ["mfu_vs_h100_f32_peak", "scan_epoch_mfu",
            "bf16_mfu_vs_h100_bf16_peak", "scan_epoch_promoted_mfu",
            "b16_mfu_vs_h100_f32_peak", "b16_bf16_mfu_vs_h100_bf16_peak",
            "b16_bf16_cached_stats_mfu", "b16_bf16_cached_stats_gelu_tanh_mfu"]
    assert sorted(k for k in row if "mfu" in k) == sorted(mfus)
    assert all(row[k] is None for k in mfus)
    # the batch rows carry the estimate and the (CPU: null) measured peak
    for tag in ("b16_bf16_", "b16_"):
        assert row[f"{tag}est_hbm_gb"] > 0 and row[f"{tag}peak_gb"] is None
    launches = [ln for ln in err.splitlines()
                if ln.startswith("# bench-launches: ")]
    assert len(launches) == 1
    # the CPU runs the kernels' plain versions: no launch
    assert set(json.loads(launches[0].split(": ", 1)[1]).values()) == {0}
