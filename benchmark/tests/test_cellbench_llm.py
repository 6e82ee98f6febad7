"""The text-embedding cell (``drivers/text_embed_closed_loop.py``) on the
CPU at small shapes: it comes out correct through ``run.main``, clean
and traced; each fault of ``benchcore/faults_llm.py``
makes the text cell not correct; the traffic's ladder holds three
documents of each chunk count; the FLOP and byte counts at DeepSeek-V2-
Lite's widths; the new readers find nothing in a trace without their
operations and never read 0."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR

torch.set_num_threads(2)

# DeepSeek-V2's block at a tiny size: hidden 64, 4 heads (nope 16, rope 8,
# v 16), latent 32, 8 experts top-2 of width 32, 2 shared, 3 layers (the
# first dense), 16-token chunks through a 128-position cache; the ladder's
# 24 documents have 1 to 8 chunks.  Weights N(0, 0.15²), so that attention
# is not near-uniform and each fault shows.
LLM = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
       "moe_intermediate_size": 32, "num_hidden_layers": 3,
       "num_attention_heads": 4, "n_routed_experts": 8,
       "n_shared_experts": 2, "num_experts_per_tok": 2, "kv_lora_rank": 32,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
       "initializer_range": 0.15, "text.chunk_tokens": 16,
       "text.cache_positions": 128, "traffic.max_tokens": 128,
       "traffic.trace_requests": 2}
# the cell's limits are set at its own size; at this one a bf16 program
# reads output 1.0-1.9e-2 and route gaps up to 9e-3 (its near-ties), and
# every fault 0.12 or more
TINY_LIMITS = {"output": {"limit": 3e-2}, "route_gap": {"limit": 2e-2},
               "words": {"limit": 0}, "eager_chunks": {"limit": 0}}
CELL = "dsv2lite_embed_2to16k"
SEED = 4294967311


def _run(capsys, monkeypatch, fault=None, trace=0):
    import run
    from benchcore.faults_llm import planted
    from benchcore.spec import Spec

    monkeypatch.setattr(Spec, "limits", lambda self, c: TINY_LIMITS)
    with planted(fault) if fault else contextlib.nullcontext():
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", config_overrides=LLM)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_the_text_cell_comes_out_correct(capsys, monkeypatch):
    line = _run(capsys, monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"request_ms_p50", "request_ms_p95",
                                    "setup_s"}
    assert line["attempted"] % 24 == 0 and line["attempted"] >= 48
    assert line["checks"]["words"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["shared_dropped", "cache_not_carried",
                                   "route_negated", "m2_dropped",
                                   "rope_interleaved"])
def test_a_fault_in_the_text_embedding_is_not_correct(fault, capsys,
                                                      monkeypatch):
    line = _run(capsys, monkeypatch, fault)
    assert line["correct"] is False
    assert line["checks"]["words"]["value"] == 0.0


def test_the_traced_run_reads_the_host_clock_and_the_counter(capsys,
                                                             monkeypatch):
    """On the CPU the trace holds no device operation, so the readers of
    the device trace and of the program's spans find nothing; the MFU is
    read from the untraced window and the load from the counter."""
    line = _run(capsys, monkeypatch, trace=1)
    assert set(line["metrics"]) == {"llm.request_mfu",
                                    "llm.expert_load_imbalance"}
    assert line["metrics"]["llm.request_mfu"]["value"] > 0
    assert line["metrics"]["llm.expert_load_imbalance"]["value"] >= 1


def test_the_ladder_holds_three_documents_of_each_chunk_count():
    import drivers.text_embed_closed_loop as tc
    from benchcore.spec import Spec

    spec = Spec()
    cell = spec.cell(CELL)
    cfg, mix = spec.config(cell), spec.traffic(cell)
    ns = tc.lengths(mix)
    assert ns[-1] == 16384 and ns[0] == 683
    counts = [tc.chunks_of(cfg, n) for n in ns]
    assert counts == sorted(counts)
    assert {c: counts.count(c) for c in set(counts)} == dict.fromkeys(
        range(1, 9), 3)


def test_the_documents_and_words_come_from_the_seed():
    import drivers.text_embed_closed_loop as tc

    cfg = {"vocab_size": 50, "text": {"chunk_tokens": 16}}
    mix = {"documents": 4, "max_tokens": 40, "word_tokens": [1, 3]}
    a = tc.documents(cfg, mix, 2**40 + 3, "cpu")
    b = tc.documents(cfg, mix, 2**40 + 3, "cpu")
    c = tc.documents(cfg, mix, 7, "cpu")
    assert all(torch.equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    assert not all(torch.equal(x[0], y[0]) for x, y in zip(a, c))
    for ids, ends in a:
        lens = np.diff(np.concatenate([[0], ends]))
        assert ends[-1] == len(ids) and lens.min() >= 1 and lens.max() <= 3


def test_the_counts_at_the_published_widths():
    """4.48 GFLOP a token outside attention's core; 10,240 a (query, key)
    pair a layer; a chunk's routed GEMMs bound by the experts' bytes (1.11
    GB a layer: 330 µs) and not their 213 GFLOP (215 µs)."""
    from benchcore import counts_llm as cl

    path = os.path.join(BENCH_DIR, "configs", "deepseek_v2_lite.json")
    with open(path) as f:
        m = json.load(f)
    assert cl.moe_layer_count(m) == 26
    assert cl.token_flops(m) == pytest.approx(4.48e9, rel=2e-3)
    assert cl.attention_flops(m, 2) - cl.attention_flops(m, 1) == \
        pytest.approx(27 * 2 * 10240)
    assert cl.doc_flops(m, 16384) == pytest.approx(
        16384 * cl.token_flops(m) + 27 * 10240 * 16384 * 16385 / 2)
    bound = cl.experts_gemm_bound_s(m, 2048)
    weights = 64 * 3 * 2048 * 1408 * 2
    assert weights == pytest.approx(1.107e9, rel=1e-3)
    assert 330e-6 < bound < 420e-6
    assert cl.moe_kernels_bound_s(m, 2048) == pytest.approx(
        (4.0 * (2048 * 64 + 2048 * 6 * 4 + 64)
         + 2.0 * (2048 * 6 * 2048 + 2 * 2048 * 2048) + 8.0 * 2048 * 6)
        / 3.35e12)


def test_the_new_readers_find_nothing_where_there_is_nothing():
    """A record without the program's operations, spans or counter (the
    parent's program, or a CPU run): every new reader returns None, never
    0, and none raises."""
    from benchcore.spec import Spec
    from benchcore.trace import Trace

    spec = Spec()
    new = [m for m in spec.doc["per_layer"] if m["name"].startswith("llm.")]
    assert len(new) == 9
    assert all(m["workloads"] == [CELL] for m in new)
    bare = {"trace": Trace(device=[("some_kernel", 0.0, 5.0)], window=(0, 10),
                           units=2),
            "llm": {"model": {}, "chunk_tokens": 16}}
    for m in new:
        if m["name"] != "llm.request_mfu":
            assert spec.reader(m).read(bare) is None, m["name"]
        assert spec.reader(m).read({}) is None, m["name"]
