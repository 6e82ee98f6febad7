"""The Kimi-Linear text-embedding cell (``drivers/kimi_embed_closed_loop.py``)
on the CPU at small shapes: its files are found by name; it comes out
correct through ``run.main``, clean and traced; each fault of
``benchcore/faults_kimi.py`` makes it not correct; the traffic's ladder;
the counts of ``benchcore/counts_kimi.py`` on a hand-worked case and at
the published widths; each new reader on a synthetic record, and none
where there is nothing to read."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH_DIR

torch.set_num_threads(2)

CELL = "kimilinear_embed_2to32k"
SEED = 4294967311
# Kimi-Linear's block at a tiny size: hidden 64, one period (KDA, KDA, KDA,
# MLA) and a KDA layer, KDA heads 4 x 16 with a convolution of 4, MLA 4
# heads (nope 16, rope 8, v 16, latent 32), 16 experts top-4 of width 32
# of which 8 held, one shared; 16-token chunks through a 256-position
# cache, so that the ladder's 24 documents have 1 to 16 chunks.  Weights
# N(0, 0.15^2), so that attention is not near-uniform and each fault shows.
LA = {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16,
      "num_heads": 4, "short_conv_kernel_size": 4}
KIMI = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
        "moe_intermediate_size": 32, "num_hidden_layers": 5,
        "num_attention_heads": 4, "num_experts": 16,
        "num_experts_per_token": 4, "experts_held": 8, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
        "linear_attn_config": LA, "initializer_range": 0.15,
        "text.chunk_tokens": 16, "text.cache_positions": 256,
        "traffic.max_tokens": 256, "traffic.trace_requests": 2}
# the cell's limits are set at its own size; at this one a bf16 program
# reads output 2.2-3.0e-2 and route gaps 2.0-2.7e-2 (its near-ties) over
# five seeds, and every fault 0.35 or more in both
TINY_LIMITS = {"output": {"limit": 6e-2}, "route_gap": {"limit": 4e-2},
               "words": {"limit": 0}, "eager_chunks": {"limit": 0}}
NEW = ("kimi.request_mfu", "kimi.kda_ms_per_chunk",
       "kimi.kda_kernel_roofline_share", "kimi.mla_ms_per_chunk",
       "kimi.experts_ms_per_chunk", "kimi.route_ms_per_chunk",
       "kimi.host_exposed_ms_per_chunk")


def _run(capsys, monkeypatch, fault=None, trace=0):
    import run
    from benchcore.faults_kimi import planted
    from benchcore.spec import Spec

    monkeypatch.setattr(Spec, "limits", lambda self, c: TINY_LIMITS)
    with planted(fault) if fault else contextlib.nullcontext():
        rc = run.main(["--workload", CELL, "--seed", str(SEED),
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", config_overrides=KIMI)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _published():
    with open(os.path.join(BENCH_DIR, "configs",
                           "kimi_linear_48b_a3b.json")) as f:
        return json.load(f)


def test_the_cells_files_are_found_by_name():
    """The cell's configuration, traffic mix, driver, limits and readers
    come from ``BENCHMARK.json`` and the files under ``benchmark/`` by
    name; the configuration keeps every published width."""
    from benchcore.spec import Spec

    spec = Spec()
    cell = spec.cell(CELL)
    assert cell["chips"] == 1 and cell["config"] == "kimi_linear_48b_a3b"
    cfg, mix = spec.config(cell), spec.traffic(cell)
    assert mix["driver"] == "kimi_embed_closed_loop"
    assert spec.driver(mix).run.__module__ == \
        "bench_driver_kimi_embed_closed_loop"
    assert set(spec.limits(cell)) == {"output", "route_gap", "words",
                                      "eager_chunks"}
    names = {m["name"] for m in spec.per_layer(cell)}
    assert names == set(NEW)
    for m in spec.per_layer(cell):
        assert callable(spec.reader(m).read)
    assert {m["name"] for m in spec.end_to_end(cell)} == {
        "request_ms_p50", "request_ms_p95", "setup_s"}
    assert cfg["num_experts"] == 256 and cfg["experts_held"] == 128
    assert cfg["reduced"] == ["num_experts"]
    assert (cfg["hidden_size"], cfg["moe_intermediate_size"],
            cfg["linear_attn_config"]["head_dim"]) == (2304, 1024, 128)


def test_the_kimi_cell_comes_out_correct(capsys, monkeypatch):
    line = _run(capsys, monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0
    assert set(line["metrics"]) == {"request_ms_p50", "request_ms_p95",
                                    "setup_s"}
    assert line["attempted"] % 24 == 0 and line["attempted"] >= 48
    assert line["checks"]["words"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["route_negated", "kda_state_dropped",
                                   "conv_tail_dropped", "kda_decay_scalar"])
def test_a_fault_in_the_kimi_embedding_is_not_correct(fault, capsys,
                                                      monkeypatch):
    line = _run(capsys, monkeypatch, fault)
    assert line["correct"] is False
    assert line["checks"]["words"]["value"] == 0.0


def test_the_traced_run_reads_the_host_clock(capsys, monkeypatch):
    """On the CPU the trace holds no device operation, so the readers of
    the device trace and of the program's spans find nothing; the MFU is
    read from the untraced window."""
    line = _run(capsys, monkeypatch, trace=1)
    assert set(line["metrics"]) == {"kimi.request_mfu"}
    assert line["metrics"]["kimi.request_mfu"]["value"] > 0


def test_the_ladder_holds_1_to_16_chunks():
    """24 documents of j · 32,768 / 24 tokens: 1,365 to 32,768, 1 to 16
    chunks of 2,048, 208 chunks a pass, each kept chunk count present."""
    import drivers.text_embed_closed_loop as tc
    from benchcore.spec import Spec

    spec = Spec()
    cell = spec.cell(CELL)
    cfg, mix = spec.config(cell), spec.traffic(cell)
    ns = tc.lengths(mix)
    assert ns[0] == 1365 and ns[-1] == 32768 and len(ns) == 24
    counts = [tc.chunks_of(cfg, n) for n in ns]
    assert counts == sorted(counts) and sum(counts) == 208
    assert set(counts) == set(range(1, 17))
    assert all(c in counts for c in mix["kept_chunks"])


def test_the_kda_counts_on_a_hand_worked_case():
    """One head of d = 2, one sub-chunk of 64: A and Aqk 2·64²·2, the
    solve 64³/6, W and U′ 2·64²·2, W·S₀, (q ⊙ e^G)·S₀ and the update
    3·64·2², Aqk·U 64²·2 multiply-adds; bytes a token 4·2·2 + 2·4 + 4,
    the state 2·2²·4 twice."""
    from benchcore import counts_kimi as ck

    m = {"linear_attn_config": {"num_heads": 1, "head_dim": 2}}
    macs = 2 * 4096 * 2 + 64 ** 3 / 6 + 2 * 4096 * 2 + 3 * 64 * 4 + 4096 * 2
    assert ck.kda_sub_flops(2) == pytest.approx(2 * macs)
    assert ck.kda_chunk_flops(m, 64) == pytest.approx(2 * macs)
    assert ck.kda_chunk_flops(m, 65) == pytest.approx(4 * macs)
    assert ck.kda_chunk_bytes(m, 10) == 10 * (16 + 8 + 4) + 2 * 4 * 4


def test_the_counts_at_the_published_widths():
    """A 2,048-token chunk of 32 heads: the KDA kernel moves 105.1 MB (31.4
    µs at 3.35 TB/s) against 11.9 GFLOP (12.0 µs at 989 TFLOP/s), so bytes
    bound it; a token's model FLOPs with 128 of 256 experts held come to
    ~3.9 GFLOP, 7 MLA layers attend over 20,480 FLOPs a (query, key)
    pair."""
    from benchcore import counts_kimi as ck

    m = _published()
    assert ck.kda_chunk_bytes(m, 2048) == pytest.approx(105.1e6, rel=1e-3)
    assert ck.kda_chunk_flops(m, 2048) == pytest.approx(11.90e9, rel=1e-3)
    assert ck.kda_bound_s(m, 2048) == pytest.approx(105.1e6 / 3.35e12,
                                                    rel=1e-3)
    assert 3.5e9 < ck.token_flops(m) < 4.3e9
    assert ck.attention_flops(m, 2) - ck.attention_flops(m, 1) == \
        pytest.approx(7 * 2 * 20480)
    full = dict(m, experts_held=256)
    assert ck.token_flops(full) - ck.token_flops(m) == pytest.approx(
        26 * 4 * 2 * 3 * 2304 * 1024)


def _record(device, units=2, chunk=2048):
    from benchcore.trace import Trace

    return {"trace": Trace(device=device, window=(0, 1e6), units=units),
            "llm": {"model": _published(), "chunk_tokens": chunk}}


def test_the_kda_roofline_reads_the_kernels_by_name():
    """Two traced chunks whose KDA kernels took 2 · 20 · 300 µs read the
    bound's 20 · 2 · 31.4 µs over that; other kernels are not counted."""
    from benchcore import counts_kimi as ck
    from benchcore.spec import Spec

    spec = Spec()
    m = {e["name"]: e for e in spec.doc["per_layer"]}
    ops = []
    for i in range(40):
        ops += [(f"(anonymous namespace)::kda_prep_kernel(x{i})", 1000.0 * i,
                 1000.0 * i + 200), ("kda_state_kernel", 1000.0 * i + 200,
                                     1000.0 * i + 300),
                ("some_gemm", 1000.0 * i + 300, 1000.0 * i + 900)]
    got = spec.reader(m["kimi.kda_kernel_roofline_share"]).read(
        _record(ops))
    want = 100 * 2 * 20 * ck.kda_bound_s(_published(), 2048) * 1e6 \
        / (40 * 300)
    assert got == pytest.approx(want) and 5 < got < 15


def test_the_mfu_reads_the_window():
    from benchcore.spec import Spec

    spec = Spec()
    m = {e["name"]: e for e in spec.doc["per_layer"]}
    rec = {"window_flops": 989e12 * 2.0, "request_s": 10.0,
           "peak_flops": 989e12}
    assert spec.reader(m["kimi.request_mfu"]).read(rec) == pytest.approx(20.0)


def test_the_new_readers_find_nothing_where_there_is_nothing():
    """A record without the program's operations, spans or tables (the
    parent's program, or a CPU run): every new reader returns None, never
    0, and none raises."""
    from benchcore.spec import Spec

    spec = Spec()
    new = [m for m in spec.doc["per_layer"] if m["name"].startswith("kimi.")]
    assert [m["name"] for m in new] == list(NEW)
    assert all(m["workloads"] == [CELL] and m["moves"] == "request_ms_p50"
               for m in new)
    bare = _record([("some_kernel", 0.0, 5.0)])
    for m in new:
        if m["name"] != "kimi.request_mfu":
            assert spec.reader(m).read(bare) is None, m["name"]
        assert spec.reader(m).read({}) is None, m["name"]


def test_the_weights_come_from_the_seed():
    """The driver's draws: bf16 N(0, σ²) kernels, ones, the f32 selection
    bias, A_log in [0, log 16] and dt_bias the softplus⁻¹ of a dt in [1e-3,
    0.1]; the same seed gives the same weights."""
    import drivers.kimi_embed_closed_loop as kc

    cfg = {"initializer_range": 0.02}
    a = kc.draw("x", (4096,), "normal", cfg, 2**40 + 1, "cpu")
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, kc.draw("x", (4096,), "normal", cfg, 2**40 + 1,
                                  "cpu"))
    assert 0.018 < float(a.float().std()) < 0.022
    alog = kc.draw("A", (1, 1, 32, 1), "a_log", cfg, 3, "cpu")
    assert alog.dtype == torch.float32
    assert float(alog.min()) >= 0 and float(alog.max()) <= np.log(16) + 1e-6
    dt = torch.nn.functional.softplus(kc.draw("d", (4096,), "dt_bias", cfg,
                                              3, "cpu"))
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    assert kc.draw("b", (256,), "bias", cfg, 3, "cpu").dtype == torch.float32
