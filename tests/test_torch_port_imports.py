"""Import guard and device policy of the port (meg_decoding_tpu_torch).

* No module of the port, and not ``chip_smoke.py``, imports JAX, flax,
  optax, orbax, transformers, safetensors or anything of the JAX package:
  an AST scan of every file, plus a subprocess that imports every module
  with those, matplotlib and wandb blocked; matplotlib is imported only
  inside functions (the figures of ``cli/eval_analysis.py``), and wandb
  only inside the ``use_wandb`` branch of ``utils/logging.py``.
* An entry point called without ``device="cpu"`` on a machine without a GPU
  raises; it never falls back to the CPU.
* ``chip_smoke.py`` fails, printing no result, without a GPU and when it
  stands alone in a directory.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "meg_decoding_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "meg_decoding_tpu",
             "transformers", "safetensors")
# importable only inside the functions that draw figures or log to wandb
# (neither is on the machine with the card)
LAZY_ONLY = ("matplotlib", "seaborn", "wandb")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_ast_scan_finds_no_jax_imports():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), n) for f in files
           for n in _imported_names(f) if _forbidden(n)]
    assert bad == []


def test_matplotlib_is_imported_only_inside_functions():
    bad = []
    for f in _port_files():
        tree = ast.parse(open(f).read(), filename=f)
        for node in tree.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(os.path.relpath(f, ROOT), n) for n in names
                    if n.split(".")[0] in LAZY_ONLY]
    assert bad == []


def test_every_module_imports_with_jax_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for m in {FORBIDDEN + LAZY_ONLY!r}: sys.modules[m] = None\n"
        "import meg_decoding_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 15


def test_entry_points_refuse_cuda_without_a_gpu(monkeypatch, tmp_path):
    from meg_decoding_tpu_torch.cli import (
        build_gwilliams_cache,
        evaluate_god,
        export_model,
        main,
        serving_benchmark,
        train_god,
        train_speech,
    )
    from meg_decoding_tpu_torch.data.prefetch import prefetch_to_device
    from meg_decoding_tpu_torch.serving.export import load_artifact
    from meg_decoding_tpu_torch.cli.evaluate_speech import run
    from meg_decoding_tpu_torch.data.brennan import embed_brennan_audio
    from meg_decoding_tpu_torch.data.gwilliams import preprocess_recordings
    from meg_decoding_tpu_torch.features import clip_features, wav2vec
    from meg_decoding_tpu_torch.core.config import compose
    from meg_decoding_tpu_torch.data.god import build_god_dataset
    from meg_decoding_tpu_torch.data.gwilliams import build_gwilliams_dataset
    from meg_decoding_tpu_torch.device import resolve_device
    from meg_decoding_tpu_torch.models.factory import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = compose(os.path.join(ROOT, "configs"), "config",
                  [f"cache_dir={tmp_path}", "num_subjects=2"])
    god_cfg = compose(os.path.join(ROOT, "configs"), "config_GOD",
                      [f"data_root={tmp_path}"])
    calls = [
        lambda: resolve_device(),
        lambda: get_model(cfg, np.full((208, 2), 0.5, np.float32)),
        lambda: build_gwilliams_dataset(cfg, {}, {}, {}, {}, {}),
        lambda: run(cfg),
        lambda: train_speech.run(cfg),
        lambda: build_god_dataset(god_cfg, "train"),
        lambda: train_god.run(god_cfg),
        lambda: evaluate_god.run(god_cfg),
        lambda: train_god.main(["--config-path", os.path.join(ROOT, "configs"),
                                f"data_root={tmp_path}"]),
        lambda: wav2vec.load_wav2vec(backend="random", num_hidden_layers=1),
        lambda: clip_features.load_clip(backend="random"),
        lambda: clip_features.preprocess_images(np.zeros((1, 8, 8, 3), np.uint8)),
        lambda: preprocess_recordings(np.zeros((2, 1000)), 1000.0, 1.0, 60.0,
                                      120.0),
        lambda: embed_brennan_audio(cfg, str(tmp_path / "y.npy")),
        lambda: build_gwilliams_cache.build_y(cfg, str(tmp_path)),
        lambda: main.train_main(["dataset=GOD", f"data_root={tmp_path}"]),
        lambda: main.evaluate_main(["dataset=GOD", f"data_root={tmp_path}"]),
        lambda: export_model.run(cfg),
        lambda: serving_benchmark.main(["--batches", "1"]),
        lambda: load_artifact(str(tmp_path)),
        lambda: prefetch_to_device(iter([])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu").type == "cpu"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_gpu_or_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    out = _run_smoke(alone)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
