"""The harness finds a cell's configuration, traffic mix, driver, limits
and per-layer readers by name: a new cell is new files plus new entries
in ``BENCHMARK.json``, and no file already there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

DRIVER = '''
def run(ctx):
    return {"e2e": {"dummy_rate": ctx.mix["rate"] * ctx.config["model"]["k"],
                    "setup_s": 0.25},
            "numbers": {"exact": 0.0}, "attempted": 3, "failed": 0,
            "memory_peak_bytes": 0, "units": ctx.seed}
'''
READER = '''
def read(record):
    return record["e2e"]["dummy_rate"] + record["units"]
'''


def _digests(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "benchmark")):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _copy(tmp_path) -> str:
    root = str(tmp_path / "checkout")
    shutil.copytree(BENCH_DIR, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def _write(root, rel, text):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _run(root, *args, device="cpu"):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import run; "
            f"sys.exit(run.main(sys.argv[2:], device={device!r}))")
    return subprocess.run([sys.executable, "-c", code,
                           os.path.join(root, "benchmark"), *args],
                          capture_output=True, text=True, timeout=120)


def test_a_cell_added_as_files_runs_without_editing_any(tmp_path):
    root = _copy(tmp_path)
    before = _digests(root)
    _write(root, "benchmark/configs/dummy.json",
           json.dumps({"dataset": "none", "model": {"k": 3}}))
    _write(root, "benchmark/traffic/dummy_mix.json",
           json.dumps({"driver": "dummy_driver", "rate": 4.0}))
    _write(root, "benchmark/drivers/dummy_driver.py", DRIVER)
    _write(root, "benchmark/metrics/dummy.layer_metric.py", READER)
    _write(root, "benchmark/limits/dummy_cell.json",
           json.dumps({"exact": {"limit": 0}}))
    doc = json.load(open(os.path.join(root, "BENCHMARK.json")))
    doc["configs"].append({"name": "dummy", "source": "https://example.org",
                           "file": "benchmark/configs/dummy.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "dummy_cell", "config": "dummy",
                             "traffic": "dummy_mix", "chips": 1, "why": "test"})
    doc["end_to_end"].append({"name": "dummy_rate", "unit": "ops/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["dummy_cell"]})
    doc["per_layer"].append({"name": "dummy.layer_metric", "unit": "ops/s",
                             "better": "higher", "source": "host_clock",
                             "layer": "dummy", "moves": "dummy_rate",
                             "workloads": ["dummy_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)

    out = _run(root, "--workload", "dummy_cell", "--seed", "2147483653",
               "--seconds", "1", "--trace", "0")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] == 3
    assert line["metrics"] == {"dummy_rate": {"value": 12.0, "unit": "ops/s"},
                               "setup_s": {"value": 0.25, "unit": "s"}}
    assert list(line)[-1] == "checks"
    assert line["checks"] == {"exact": {"value": 0.0, "limit": 0.0}}
    assert out.stderr.strip().splitlines()[-1].startswith("check exact:")

    out = _run(root, "--workload", "dummy_cell", "--seed", "5",
               "--seconds", "1", "--trace", "1")
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {"dummy.layer_metric":
                               {"value": 17.0, "unit": "ops/s"}}
    after = _digests(root)
    assert {k: after[k] for k in before} == before


def test_no_card_no_result(tmp_path):
    """Without a card (this machine) the command exits non-zero and
    prints no result; so it does in a checkout that holds only the
    benchmark's files."""
    root = _copy(tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "speech_train_f32_b64", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
