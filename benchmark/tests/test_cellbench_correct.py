"""What decides ``correct``, on the CPU at small shapes: the reference
agrees with the program; every cell's run comes out correct; each fault
planted under the timed path makes it not correct; the benchmark loads
no JAX and its reference nothing of the program."""

import ast
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from cellbench_tiny import CELLS, LIMITS
from conftest import BENCH_DIR

torch.set_num_threads(2)


def _run(cell, capsys, monkeypatch, fault=None, seed=2147483659):
    import run
    from benchcore.faults import planted
    from benchcore.spec import Spec

    limits = Spec.limits

    def small_limits(self, c):
        out = limits(self, c)
        for k, v in LIMITS.get(c["name"], {}).items():
            out[k]["limit"] = v
        return out

    monkeypatch.setattr(Spec, "limits", small_limits)
    with planted(fault) if fault else contextlib.nullcontext():
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.3", "--trace", "0"], device="cpu",
                      config_overrides=CELLS[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_reference_encoder_agrees_with_the_programs():
    from benchcore.data import make_running, make_weights, sensor_locations
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder
    from reference.model import buffer_spec, forward, fourier_basis, param_spec

    cfg = {"model": {"C": 12, "K": 4}, "sensor_xy": None}
    loc = sensor_locations(cfg)
    w = make_weights(param_spec(12, 3, 16, 24, 16, 4), 5.1, 7, "cpu")
    run_stats = make_running(buffer_spec(24), 7, "cpu")
    for seq2seq in (True, False):
        model = BrainEncoder(loc, 3, D1=16, D2=24, F=16, K=4,
                             seq2seq=seq2seq)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(w[k])
            for k, b in model.named_buffers():
                if k in run_stats:
                    b.copy_(run_stats[k])
        X = torch.randn(8, 12, 40, generator=torch.Generator().manual_seed(1))
        subs = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
        loc_t = torch.as_tensor(loc)
        cos, sin = fourier_basis(loc, 4, "cpu")
        for train in (True, False):
            model.train(train)
            got = model(X, subs, centre=3) if train else model(X, subs)
            want, _ = forward(w, run_stats, X, subs, loc_t, cos, sin,
                              num_blocks=5, seq2seq=seq2seq, train=train,
                              centre=3)
            assert torch.allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_comes_out_correct(cell, capsys, monkeypatch):
    line = _run(cell, capsys, monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [
    ("speech_train_f32_b64", "state_unchanged"),
    ("speech_train_f32_b64", "half_batch"),
    ("speech_train_f32_b64", "answer_altered"),
    ("god_train_b64", "half_batch"),
    ("speech_serve_b1", "answer_altered"),
])
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, capsys,
                                                     monkeypatch):
    assert _run(cell, capsys, monkeypatch, fault)["correct"] is False


def test_the_reference_gathers_what_the_program_gathers():
    """The speech batch cut by plain indexing equals the program's window
    gather at the same draws."""
    from benchcore.data import make_data
    from meg_decoding_tpu_torch.data.gwilliams import _gather_batch
    from reference.train import gather_speech

    cfg = {"dataset": "speech", "model": {"C": 12, "F": 16},
           "data": {"subjects": 3, "sessions_per_subject": 2, "tasks": 4,
                    "rate": 120, "rec_sec": 30.0, "seq_len_sec": 3,
                    "words_per_task": 24}}
    d = make_data(cfg, 11, "cpu")
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, d.segments, 16))
    sess = torch.as_tensor(rng.integers(0, d.sessions, 16))
    task, word = idx // d.words, idx % d.words
    want = _gather_batch(d.recordings, d.y_stream, d.meg_onsets,
                         d.speech_onsets, d.session_subject, task, word, sess,
                         d.seq_len)
    got = gather_speech(d.recordings, d.y_stream, d.meg_onsets,
                        d.speech_onsets, d.session_subject, task, word, sess,
                        d.seq_len)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_and_no_program_in_the_reference():
    for dirpath, _, files in os.walk(BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(_imports(path))
            assert not names & {"jax", "jaxlib", "flax", "meg_decoding_tpu"}, path
            if os.path.basename(dirpath) == "reference":
                assert "meg_decoding_tpu_torch" not in names, path


@pytest.mark.parametrize("numbers, correct", [
    ({"loss": 1e-5, "eager_steps": 0.0}, True),
    ({"loss": 1e-5}, False),                          # a limit's number missing
    ({"loss": 1e-5, "eager_steps": 0.0, "new": 0.0}, False),  # no limit
    ({"loss": float("nan"), "eager_steps": 0.0}, False),
    ({"loss": 2e-3, "eager_steps": 0.0}, False),
])
def test_judge_holds_every_limit_and_only_limited_numbers(numbers, correct):
    from benchcore import checks

    limits = {"loss": {"limit": 1e-3}, "eager_steps": {"limit": 0}}
    ok, rows = checks.judge(numbers, limits)
    assert ok is correct
    assert set(limits) <= set(rows)
