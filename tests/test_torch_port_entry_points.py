"""The port's dispatching entry points (``cli/main.py``, ``train_torch.py``,
``evaluate_torch.py``) against the JAX package's ``cli/main.py``, on the
CPU: the argument handling on a table of argvs (exact: the same configs
composed from the same files), both dispatches on synthetic GOD sessions
and a synthetic Gwilliams cache, and ``-m`` sweeps of two jobs (as
``tests/test_cli.py`` runs JAX's), each job in its own directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from meg_decoding_tpu.cli import main as jmain
from meg_decoding_tpu.core.config import to_dict as jto_dict
from meg_decoding_tpu_torch.cli import main
from meg_decoding_tpu_torch.core.config import to_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["D1=16", "D2=24", "K=4", "F=16"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGVS = [
    [],
    ["dataset=GOD"],
    ["dataset=Brennan2018", "preprocs.clamp_lim=10"],
    ["--config-name", "config_GOD", "epochs=3"],
    ["-cn", "throughput", "dataset=Gwilliams2022"],
    ["--config-name=config_GOD", "dataset=GOD", "lr=1e-4"],
    ["dataset=Gwilliams2022", "preprocs.brain_filter_high=40", "seed=3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
@pytest.mark.parametrize("default", ["config", "config_GOD"])
def test_parse_cli_auto_matches_jax(argv, default):
    got = main.parse_cli_auto(argv, default_config_name=default)
    want = jmain.parse_cli_auto(argv, default_config_name=default)
    assert to_dict(got) == jto_dict(want)


@pytest.mark.parametrize("argv", [
    ["lr=1e-3,1e-4"],
    ["-m", "dataset=GOD", "lr=1e-3,1e-4", "seed=0,1"],
    ["--multirun", "preprocs.brain_filter=[2,5]", "seed=0,1"],
    ["-m", "--config-name", "config_GOD", "subjects={a: 1, b: 2}"],
    ["-m", "epochs=2"],
])
def test_expand_multirun_matches_jax(argv):
    assert main.expand_multirun(argv) == jmain.expand_multirun(argv)


def test_bad_arguments_fail_like_jax():
    for bad in (["oops"], ["--config-name"]):
        with pytest.raises(SystemExit) as got:
            main.parse_cli(bad)
        with pytest.raises(SystemExit) as want:
            jmain.parse_cli(bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown dataset"):
        main.dispatch_train(main.parse_cli(["dataset=MNIST"]), "cpu")


def test_device_flag_is_split_off():
    assert main.split_device(["dataset=GOD"]) == (["dataset=GOD"], "cuda")
    assert main.split_device(["--device", "cpu", "-m", "seed=0,1"]) == (
        ["-m", "seed=0,1"], "cpu")
    assert main.split_device(["--device=cpu", "x=1"]) == (["x=1"], "cpu")
    with pytest.raises(SystemExit):
        main.split_device(["--device"])


@pytest.fixture(scope="module")
def god_args(tmp_path_factory):
    """Overrides of configs/config_GOD.yaml for one synthetic subject (40
    train and 10 val trials at 200 Hz, 12 channels, 8 in the ROI): 2
    updates an epoch at batch 16."""
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_god_dataset

    root = str(tmp_path_factory.mktemp("god_entry"))
    make_synthetic_god_dataset(root, subjects=("sbj01",), n_train=40,
                               n_test=10)
    files = lambda name: "{mat: [%s], labels: [%s], trigger: [%s], rest: [%s]}" % (
        (name,) * 4)
    return ["dataset=GOD", f"data_root={root}",
            "subjects={sbj01: {fs: 200, train: %s, val: %s}}" % (
                files("train.mat"), files("val.mat")),
            "num_meg_channels=12", f"ch_region_path={root}/ch_region.json",
            f"montage_path={root}/montage.csv", "enforce_split_sizes=false",
            "epochs=1", "updates=2", "batch_size=16", "image_features_path=null",
            *SMALL]


def test_god_train_and_evaluate_dispatch(god_args, tmp_path):
    out = str(tmp_path / "out")
    best = main.train_main(["--device", "cpu", *god_args, f"save_root={out}",
                            "run_name=g"])
    assert best["train_skipped"] == 0.0 and np.isfinite(best["train_loss"])
    assert os.path.exists(os.path.join(out, "ckpt", "model_best.pt"))
    res = main.evaluate_main(["--device", "cpu", *god_args, f"save_root={out}"])
    assert {"val_top1", "pairwise_cosine"} <= set(res)
    with open(os.path.join(out, "eval_results.json")) as f:
        assert json.load(f) == res


def test_speech_train_and_evaluate_dispatch(tmp_path):
    from meg_decoding_tpu_torch.data.synthetic import make_synthetic_gwilliams_cache

    cache = str(tmp_path / "cache")
    make_synthetic_gwilliams_cache(cache, n_subjects=2, n_sessions_per=1, C=12,
                                   rate=120, rec_sec=20.0, words_per_task=24,
                                   F=16)
    args = ["--device", "cpu", "dataset=Gwilliams2022", f"cache_dir={cache}",
            f"save_root={tmp_path / 'out'}", "epochs=1", "updates=2",
            "batch_size=8", "preprocs.last4layers=false", "run_name=s", *SMALL]
    best = main.train_main(args)
    assert best["train_skipped"] == 0.0 and np.isfinite(best["train_loss"])
    res = main.evaluate_main(args)
    assert 0.0 <= res["test_top1"] <= res["test_top10"] <= 1.0


def test_two_job_sweeps_train_and_evaluate(god_args, tmp_path):
    """``-m seed=0,1``: two training jobs under one timestamped sweep dir,
    each with its checkpoint, overrides and result; then an evaluation
    sweep that reads the checkpoint under the original save_root."""
    out = str(tmp_path / "out")
    results = main.train_main(["-m", "--device", "cpu", *god_args,
                               f"save_root={out}", "seed=0,1"])
    assert len(results) == 2
    stamps = os.listdir(os.path.join(out, "multirun"))
    assert len(stamps) == 1
    sweep = os.path.join(out, "multirun", stamps[0])
    for num in (0, 1):
        job = os.path.join(sweep, str(num))
        assert os.path.exists(os.path.join(job, "ckpt", "model_best.pt"))
        with open(os.path.join(job, "overrides.txt")) as f:
            assert f"seed={num}" in f.read().split()
        with open(os.path.join(job, "result.json")) as f:
            assert json.load(f)["train_loss"] == pytest.approx(
                results[num]["train_loss"])
    # the evaluation sweep: the checkpoint of the first job is its input
    ckpt = os.path.join(sweep, "0")
    evals = main.evaluate_main(["-m", "--device", "cpu", *god_args,
                                f"save_root={ckpt}", "seed=0,1"])
    assert all("error" not in r and np.isfinite(r["pairwise_cosine"])
               for r in evals)
    esweep = os.path.join(ckpt, "multirun")
    (stamp,) = os.listdir(esweep)
    for num in (0, 1):
        assert os.path.exists(os.path.join(esweep, stamp, str(num),
                                           "eval_results.json"))


def test_root_scripts_refuse_cuda_without_a_gpu(tmp_path):
    """``train_torch.py`` / ``evaluate_torch.py`` run the port's dispatch;
    without ``--device cpu`` on a machine without a GPU they raise."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the scripts would run for real")
    for script in ("train_torch.py", "evaluate_torch.py"):
        out = subprocess.run(
            [sys.executable, script, "dataset=GOD",
             f"save_root={tmp_path}"], cwd=ROOT, capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0
        assert "device='cpu'" in out.stderr, out.stderr[-2000:]
