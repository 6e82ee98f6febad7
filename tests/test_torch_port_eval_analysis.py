"""The port's retrieval error analysis (``cli/eval_analysis.py``) against
the JAX package's, on the CPU: every function on seeded inputs, then the
GOD eval CLI with ``error_analysis: true`` and a synthetic ImageNet
distractor file, against JAX's eval CLI on the same predictions.

Inputs: 12 queries and 12 paired gallery rows of width 16, plus 40
distractors; the test checks first that every query's six best
similarities are more than 1e-4 apart, so the rankings compare exactly
(``top5_table`` sorts with ``np.argsort``, whose order among near-ties
follows float noise).

Tolerances: the similarities ≤ 1e-6 (f32 cosine similarities, the matmul
summed in other orders); everything derived from them (the confusion
matrix, FP/TP rates, accuracies, the top-5 table and CSV) and the numpy
double standardization — exact.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax

from meg_decoding_tpu.cli import eval_analysis as jea
from meg_decoding_tpu.core.config import Config as JConfig
from meg_decoding_tpu_torch.cli import eval_analysis as ea
from meg_decoding_tpu_torch.core.config import Config, to_dict
from meg_decoding_tpu_torch.interop import params_from_jax
from tests.test_torch_port_god_train import F, _cli_cfg, god_setup  # noqa: F401

N, D, N_DISTRACT = 12, 16, 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _top_gaps(Z, gallery) -> float:
    """The least gap between a query's six best f64 cosine similarities."""
    z = Z / np.linalg.norm(Z, axis=1, keepdims=True)
    g = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    top = -np.sort(-(z @ g.T), axis=1)[:, :6]
    return float(np.diff(-top, axis=1).min())


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    Y = rng.randn(N, D).astype(np.float32)
    Z = (Y + 0.8 * rng.randn(N, D)).astype(np.float32)
    distract = rng.randn(N_DISTRACT, D).astype(np.float32)
    mean, std = distract.mean(0), distract.std(0) + 0.5
    labels = np.arange(N) + 1
    Zs = jea.double_standardize(Z)
    assert _top_gaps(Zs, Y) > 1e-4
    assert _top_gaps(Zs, jea.extend_gallery(Y, distract, mean, std)) > 1e-4
    return dict(Y=Y, Z=Z, distract=distract, mean=mean, std=std,
                labels=labels)


def test_double_standardize_and_extend_gallery_match_jax(inputs):
    s = inputs
    assert np.array_equal(ea.double_standardize(torch.from_numpy(s["Z"])),
                          jea.double_standardize(s["Z"]))
    assert np.array_equal(
        ea.extend_gallery(s["Y"], s["distract"], s["mean"], s["std"]),
        jea.extend_gallery(s["Y"], s["distract"], s["mean"], s["std"]))
    assert np.array_equal(ea.extend_gallery(s["Y"], s["distract"]),
                          jea.extend_gallery(s["Y"], s["distract"]))


@pytest.mark.parametrize("with_distractors", [False, True])
def test_confusion_rates_and_top5_match_jax(inputs, with_distractors):
    s = inputs
    Zs = jea.double_standardize(s["Z"])
    gallery = (jea.extend_gallery(s["Y"], s["distract"], s["mean"], s["std"])
               if with_distractors else s["Y"])
    acc, mat, sim = ea.binary_confusion(Zs, gallery)
    jacc, jmat, jsim = jea.binary_confusion(Zs, gallery)
    assert sim.shape == jsim.shape == (N, len(gallery))
    assert float(np.abs(sim - jsim).max()) <= 1e-6
    assert acc == jacc and np.array_equal(mat, jmat)
    for a, b in zip(ea.fp_tp_rates(mat[:, :N]), jea.fp_tp_rates(jmat[:, :N])):
        assert np.array_equal(a, b)
    rows = ea.top5_table(sim, torch.from_numpy(s["labels"]), mat)
    assert rows == jea.top5_table(jsim, s["labels"], jmat)
    assert len(rows) == N and rows[0]["query_image_id"] == 1


@pytest.mark.parametrize("with_distractors", [False, True])
def test_run_error_analysis_matches_jax(inputs, tmp_path, with_distractors):
    """The whole pass: the result dict, the CSV byte for byte, and the
    figures (matplotlib is on this machine)."""
    s = inputs
    kw = dict(distractors=s["distract"], norm_mean=s["mean"],
              norm_std=s["std"]) if with_distractors else {}
    got = ea.run_error_analysis(torch.from_numpy(s["Z"]), s["Y"], s["labels"],
                                str(tmp_path / "port"), **kw)
    want = jea.run_error_analysis(s["Z"], s["Y"], s["labels"],
                                  str(tmp_path / "jax"), **kw)
    assert got == want
    name = "top5_with_imagenet_val.csv" if with_distractors else "top5.csv"
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == sorted(
            [name, "confusion_mat.png", "std_vs_tp.png"])
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()


def test_run_error_analysis_without_figures_needs_no_matplotlib(
        inputs, tmp_path, monkeypatch):
    """``make_plots=False`` (the eval CLI without ``image_dir``) imports no
    matplotlib: the machine with the card has none."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = ea.run_error_analysis(inputs["Z"], inputs["Y"], inputs["labels"],
                                str(tmp_path), make_plots=False)
    assert os.listdir(tmp_path) == ["top5.csv"]
    assert 0.0 <= res["similarity_acc"] <= 1.0


def test_image_tiles_match_jax(inputs, tmp_path):
    """``save_top5_image_tiles`` over a directory of ``<id>.png`` images."""
    import matplotlib.pyplot as plt

    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i in range(1, N + 1):
        plt.imsave(img_dir / f"{i}.png", np.full((4, 4, 3), i / N))
    s = inputs
    acc, mat, sim = jea.binary_confusion(jea.double_standardize(s["Z"]), s["Y"])
    rows = jea.top5_table(sim, s["labels"], mat)
    out = ea.save_top5_image_tiles(rows, str(img_dir), str(tmp_path / "port"),
                                   max_queries=3)
    jout = jea.save_top5_image_tiles(rows, str(img_dir), str(tmp_path / "jax"),
                                     max_queries=3)
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == [
        f"query_{i}.png" for i in (1, 2, 3)]


def test_god_eval_cli_error_analysis_matches_jax(god_setup, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """Both eval CLIs with ``error_analysis: true`` and a 60 × F distractor
    file, on one informative Z handed to both (as
    ``tests/test_torch_port_god_train.py`` holds the eval metrics): the
    result keys and values, and the top-5 CSV.  The val gallery holds each
    image once a subject, so a ranking may swap two equal rows: the CSV's
    ids are compared through the gallery rows they name."""
    from meg_decoding_tpu.cli import evaluate_god as jeval
    from meg_decoding_tpu.train.checkpoint import CheckpointManager as JCkpt
    from meg_decoding_tpu.train.schedules import make_optimizer as jopt
    from meg_decoding_tpu.train.state import create_train_state as jstate
    from meg_decoding_tpu_torch.cli import evaluate_god

    s = god_setup
    distract = os.path.join(str(tmp_path), "imagenet_val.npy")
    np.save(distract, np.random.RandomState(8).randn(60, F).astype(np.float32))
    cfg = _cli_cfg(s, tmp_path, epochs=1, error_analysis=True,
                   imagenet_val_features_path=distract)
    jcfg = JConfig(to_dict(cfg))
    jsource, jval, jmodel = jeval._build(jcfg)
    jst = jstate(jmodel, jopt(jcfg, 1200), jsource.gather(np.arange(8)),
                 jax.random.PRNGKey(3))
    ckpt_dir = os.path.join(cfg.save_root, "ckpt")
    JCkpt(ckpt_dir).save("model_best", jst)
    torch.save(params_from_jax(jax.tree_util.tree_map(
        np.asarray, {"params": jst.params, "batch_stats": jst.batch_stats})),
        os.path.join(ckpt_dir, "model_best.pt"))

    rng = np.random.RandomState(4)
    Zfix = (np.asarray(jval.Y) + 1.5 * rng.randn(*np.asarray(jval.Y).shape)
            ).astype(np.float32)
    monkeypatch.setattr(jeval, "predict", lambda *a, **k: Zfix)
    monkeypatch.setattr(evaluate_god, "predict",
                        lambda *a, **k: torch.from_numpy(Zfix))
    pcfg = Config(to_dict(cfg))
    pcfg.save_root = str(tmp_path / "port")
    pcfg.ckpt_dir = ckpt_dir
    got = evaluate_god.run(pcfg, device="cpu")
    jcfg.save_root = str(tmp_path / "jax")
    jcfg.ckpt_dir = ckpt_dir
    want = jeval.run(jcfg)
    assert set(got) == set(want) >= {"similarity_acc", "mean_acc_scene"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    # figures need image_dir in the port (no matplotlib on the card's machine)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "eval_results.json", "top5_with_imagenet_val.csv"]

    gallery = jea.extend_gallery(np.asarray(jval.Y), np.load(distract),
                                 np.asarray(jval.mean_Y), np.asarray(jval.std_Y))

    def read(d):
        with open(tmp_path / d / "top5_with_imagenet_val.csv") as f:
            return list(csv.DictReader(f))

    prow, jrow = read("port"), read("jax")
    assert len(prow) == len(jrow) == len(Zfix)
    for p, j in zip(prow, jrow):
        assert p["query_image_id"] == j["query_image_id"]
        assert p["acc(scene_id)"] == j["acc(scene_id)"]
        for k in range(1, 6):
            a, b = int(p[f"top{k}_image_id"]), int(j[f"top{k}_image_id"])
            assert np.array_equal(gallery[a - 1], gallery[b - 1]), (k, a, b)
