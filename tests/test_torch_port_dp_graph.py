"""The data-parallel routes as captured graphs (``train/graph.py``), on the
CPU: a 2-rank gloo group (``tests/torch_dp_worker.py``, started once for
this module as ``tests/test_torch_port_data_parallel.py`` starts its own,
on the same inputs), where ``GraphedStep`` runs each body eagerly on its
static buffers and the body's collectives run over gloo.

* The fused speech DP steps and the GOD DP steps (same-label term),
  through ``GraphedStep`` on ``prepare``/``body``: bit-identical to the
  eager DP steps on the same draws (metrics and every state entry), and
  against JAX's mesh within the DP trajectory bounds of
  ``tests/test_torch_port_data_parallel.py``: loss rtol 1e-3, parameters
  rtol 1e-4 / atol 1e-5, 2·n·lr for the entries whose gradient is
  rounding noise.
* No host read in the fused DP body, the per-step DP body or the DP eval
  body at world 2: none of ``tests/test_torch_port_graph.py``'s
  ``_HostReads.FORBIDDEN`` operations is dispatched, while the
  collectives are.
* The DP test pools through the forward graph (``sharded`` bound when the
  route is built) equal the eager DP eval, bit for bit, sharded and
  whole, through one graph.
* The DP whole-epoch forms (Gwilliams, GOD) through their graph equal
  their ``eager`` form bit for bit.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_data_parallel import (
    _assert_trajectory,
    _inputs,
    _join,
    _start,
)
from tests.test_torch_port_graph import _HostReads
from tests.test_torch_port_train_slice import train_setup  # noqa: F401

CASES = ("speech", "god", "speech_graph", "god_graph", "host_reads",
         "eval_graph", "scan_graph")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dpg(train_setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_graph")
    inputs, jax_side = _inputs(train_setup, tmp)
    in_path = str(tmp / "inputs.pt")
    torch.save(inputs, in_path)
    out_dir = str(tmp / "n2")
    return {"ranks": _join(_start(2, CASES, in_path, out_dir), out_dir),
            "jax": jax_side}


def _assert_same(a, b):
    """Two ranks' results of two routes, bit for bit."""
    assert [m for m in a["metrics"]] == [m for m in b["metrics"]]
    assert a["state"].keys() == b["state"].keys()
    for k, v in a["state"].items():
        np.testing.assert_array_equal(v, b["state"][k], err_msg=k)


@pytest.mark.parametrize("kind", ["speech", "god"])
def test_dp_graph_steps_equal_eager_and_match_jax(dpg, kind):
    graph = [r[f"{kind}_graph"] for r in dpg["ranks"]]
    for g, r in zip(graph, dpg["ranks"]):
        _assert_same(g, r[kind])
    jmets, jstate = dpg["jax"][kind]
    _assert_trajectory(graph, jmets, jstate)


@pytest.mark.parametrize("body", ["fused_speech", "god_step", "eval"])
def test_dp_bodies_make_no_host_read(dpg, body):
    for r in dpg["ranks"]:
        seen = r["host_reads"][body]
        assert not seen & set(_HostReads.FORBIDDEN), seen & set(_HostReads.FORBIDDEN)
        # the mode saw the body's collectives
        assert ("allgather_" if body == "eval" else "allreduce_") in seen


@pytest.mark.parametrize("sharded", [True, False], ids=["sharded", "whole"])
def test_dp_test_pools_graph_equals_eager(dpg, sharded):
    for r in dpg["ranks"]:
        runs = r["eval_graph"][sharded]
        assert runs["graph"] == runs["eager"]
        assert runs["programs"] == 1  # every pool through one graph
        assert all(np.isfinite(v) for v in runs["graph"].values())
    # the metrics are the whole pool's on every rank
    assert dpg["ranks"][0]["eval_graph"][sharded]["graph"] == \
        dpg["ranks"][1]["eval_graph"][sharded]["graph"]


@pytest.mark.parametrize("form", ["gwilliams", "god"])
def test_dp_scan_epoch_graph_equals_eager(dpg, form):
    for r in dpg["ranks"]:
        g, e = r["scan_graph"][form]["graph"], r["scan_graph"][form]["eager"]
        assert g["graphed"] and not e["graphed"]
        assert g["means"] == e["means"] and g["means"]["skipped"] == 0.0
        _assert_same(g, e)
    a, b = (r["scan_graph"][form]["graph"] for r in dpg["ranks"])
    _assert_same(a, b)
