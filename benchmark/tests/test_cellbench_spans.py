"""The readers of the program's own tracing (``benchcore/program_trace.py``)
on a made-up traced stretch and capture table: the exposed host time and
its split by span, the staging's self time, each replay's operations put
down to their scopes, None wherever the mapping is not exact or the
program keeps no tables; and, on the card, that a traced replay's
operations in each train cell are its table's nodes."""

import sys
from types import SimpleNamespace

import pytest

from benchcore import program_trace as pt
from benchcore import trace as tr
from benchcore.spec import Spec

TRAIN = ("speech_train_f32_b64", "god_train_b64", "speech_train_exact_b256")


def _table(**kw):
    t = dict(id=7, kind="train", total=3, types="KKS",
             rows=[("gelu", 0, 1), ("adam", 1, 1), (None, 2, 1)],
             counts={"gelu": 1, "adam": 1, None: 1})
    t.update(kw)
    return SimpleNamespace(**t)


def _trace():
    """One GOD-like step in a window of 50 us: the gather (index upload
    and an index kernel), the step's draws, copy-in (a staged input),
    a replay of three nodes, copy-out; the client after 40 us."""
    host = [("data.gather#batch=0", 0, 8), ("data.upload_idx", 2, 6),
            ("cudaMemcpyAsync", 3, 4), ("cudaLaunchKernel", 6.5, 7),
            ("train.step#step=0", 9, 40), ("train.prepare", 9, 10),
            ("graph.copy_in", 10, 12), ("graph.stage_pinned", 10.2, 10.4),
            ("cudaMemcpyAsync", 10.5, 11),
            ("graph.replay#graph=7", 12, 15.5), ("cudaGraphLaunch", 12.5, 15),
            ("graph.copy_out", 20, 22), ("cudaMemcpyAsync", 20.5, 21),
            ("aten::select", 42, 43)]
    dev = [("Memcpy HtoD (Pageable -> Device)", 4, 5), ("index_kernel", 8, 9),
           ("Memcpy DtoD (Device -> Device)", 11.5, 12),
           ("gelu_kernel", 14, 16), ("adam_kernel", 16.5, 18),
           ("Memset (Device)", 18, 19),
           ("Memcpy DtoD (Device -> Device)", 21.5, 22)]
    return tr.Trace(device=dev, host=host, window=(0, 50), window_s=5e-5,
                    units=1)


@pytest.fixture
def program(monkeypatch):
    """The program's tracing module as ``sys.modules`` holds it, with one
    capture table."""
    mod = SimpleNamespace(tables={("train", "sig"): _table()})
    monkeypatch.setitem(sys.modules, pt.PROFILING, mod)
    return mod


def test_spans_and_their_stretches():
    t = _trace()
    assert pt.parse("graph.replay#graph=7") == ("graph.replay", {"graph": "7"})
    assert pt.parse("aten::select") is None
    assert [pt._letter(n) for n in ("Memcpy DtoD (Device -> Device)",
                                    "memcpy32_post", "Memset (Device)",
                                    "sm90_xmma_fprop")] == ["C", "C", "S", "K"]
    assert [s[0] for s in pt.spans(t)][:2] == ["data.gather", "data.upload_idx"]
    segs = pt.segments(t)
    assert sum(e - s for s, e, _ in segs) == 8 + 31
    own = {}
    for s, e, k in segs:
        own[k] = own.get(k, 0) + e - s
    assert own == {"data.gather": 4, "data.upload_idx": 4, "train.prepare": 1,
                   "graph.copy_in": pytest.approx(1.8),
                   "graph.stage_pinned": pytest.approx(0.2),
                   "graph.replay": 3.5, "graph.copy_out": 2,
                   "train.step": pytest.approx(31 - 1 - 2 - 3.5 - 2)}
    assert pt.self_ms({"trace": t}, "graph.stage_pinned") == \
        pytest.approx(0.2e-3)
    assert pt.self_ms({"trace": t}, "serve.request") is None


def test_attribution_and_the_scope_readers(program):
    t = _trace()
    found = pt.attribute(t, pt.tables())
    assert (found.mapped, found.replays) == (1, 1)
    assert [o for o, _, _, _ in found.ops] == [
        pt.HOST, pt.HOST, pt.HOST, "gelu", "adam", None, pt.HOST]
    # each operation's enqueueing call: its launch, or its replay's span
    assert [c for _, _, _, c in found.ops] == [4, 7, 11, 15.5, 15.5, 15.5,
                                               21]
    spec = Spec()
    read = {m["name"]: spec.reader(m).read for m in spec.doc["per_layer"]}
    record = {"trace": t}
    for pre in ("train.", "god."):
        assert read[pre + "gelu_ms_per_step"](record) == pytest.approx(2e-3)
        assert read[pre + "optimizer_ms_per_step"](record) == \
            pytest.approx(1.5e-3)
        # no operation of the replay is a batch norm's
        assert read[pre + "batchnorm_ms_per_step"](record) is None
        assert read[pre + "optimizer_ops_per_step"](record) == 1
    assert read["serve.stage_ms_per_request"](record) == pytest.approx(0.2e-3)


def test_exposed_host_time_counts_the_waits_on_the_host(program):
    t = _trace()
    gaps = pt.waiting_gaps(t, pt.attribute(t, pt.tables()).ops)
    # [16, 16.5] lies between two nodes of a graph whose launch returned
    # at 15.5: the device's own gap, not a wait on the host
    assert gaps == [(0, 4), (5, 8), (9, 11.5), (12, 14), (19, 21.5),
                    (22, 50)]
    split = pt.idle_by_span(t, gaps)
    assert split == pytest.approx({
        "data.gather": 2 + 2, "data.upload_idx": 2 + 1, "train.prepare": 1,
        "graph.copy_in": 0.2 + 1.1, "graph.stage_pinned": 0.2,
        "graph.replay": 2, "train.step": 1 + 18, "graph.copy_out": 1.5,
        "outside": 10})
    # every idle stretch, [16, 16.5] with them
    assert pt.idle_by_span(t)["train.step"] == pytest.approx(19.5)
    spec = Spec()
    read = {m["name"]: spec.reader(m).read for m in spec.doc["per_layer"]}
    # idle (50 less 7.5 busy), less the device's own gap and the client
    want = 50 - 7.5 - 0.5 - 10
    for name in ("train.exposed_host_ms_per_step",
                 "god.exposed_host_ms_per_step",
                 "serve.exposed_host_ms_per_request"):
        assert read[name]({"trace": t}) == pytest.approx(want / 1e3)
    # per unit
    t.units = 2
    assert read["god.exposed_host_ms_per_step"]({"trace": t}) == \
        pytest.approx(want / 2e3)


@pytest.mark.parametrize("fault", ["total", "types", "early", "no_rows",
                                   "other_graph"])
def test_a_mapping_that_is_not_exact_reads_none(program, fault):
    t = _trace()
    table = program.tables[("train", "sig")]
    if fault == "total":
        table.total, table.types = 4, "KKSK"
    elif fault == "types":
        table.types = "KKK"
    elif fault == "early":  # an operation before its replay's launch
        t.device[3] = ("vectorized_elementwise_kernel", 11.8, 11.9)
    elif fault == "no_rows":
        table.rows = table.counts = None
    else:
        table.id = 8
    assert pt.attribute(t, pt.tables()) is None
    spec = Spec()
    for m in spec.doc["per_layer"]:
        if m["name"].endswith(("gelu_ms_per_step", "optimizer_ms_per_step",
                               "batchnorm_ms_per_step",
                               "exposed_host_ms_per_step",
                               "exposed_host_ms_per_request")):
            assert spec.reader(m).read({"trace": t}) is None, m["name"]


@pytest.mark.parametrize("record", ["lost", "split"])
def test_a_replay_that_lost_a_record_is_left_out(program, record):
    """Three steps; the profiler lost the middle replay's Adam operation,
    or split one of its kernels in two: the other replays map, the middle
    one is left out of the scope readings, and its operations still count
    as its own for the exposed host time."""
    one = _trace()
    t = tr.Trace(window=(0, 150), window_s=1.5e-4, units=3)
    for k in range(3):
        t.host += [(n, s + 50 * k, e + 50 * k) for n, s, e in one.host]
        t.device += [(n, s + 50 * k, e + 50 * k) for n, s, e in one.device
                     if not (k == 1 and s == 16.5 and record == "lost")]
    if record == "split":
        t.device.append(("vectorized_elementwise_kernel", 66.2, 66.4))
    # the driver ran the last replay's memset node as its own kernel
    t.device[-2 if record == "lost" else -3] = ("memset32_post", 118, 119)
    found = pt.attribute(t, pt.tables())
    assert (found.mapped, found.replays) == (2, 3)
    owners = [o for o, _, _, _ in found.ops]
    n = 2 if record == "lost" else 4
    assert owners[7:7 + 3 + n + 1] == [pt.HOST] * 3 + [pt.UNMAPPED] * n + \
        [pt.HOST]
    assert owners.count("adam") == owners.count("gelu") == 2
    spec = Spec()
    read = {m["name"]: spec.reader(m).read for m in spec.doc["per_layer"]}
    record = {"trace": t}
    assert read["god.optimizer_ms_per_step"](record) == pytest.approx(1.5e-3)
    assert read["god.gelu_ms_per_step"](record) == pytest.approx(2e-3)
    assert read["god.optimizer_ops_per_step"](record) == 1
    # each step waits 32 us on the host, as the single step did: the gaps
    # that the lost or split record leaves in the middle step's replay are
    # the device's own (its launch had returned)
    assert read["god.exposed_host_ms_per_step"](record) == \
        pytest.approx(32e-3)


def test_a_split_record_outside_the_replays_is_a_host_operation(program):
    t = _trace()
    t.device.append(("Memcpy DtoD (Device -> Device)", 22, 23))
    found = pt.attribute(t, pt.tables())
    assert (found.mapped, found.replays) == (1, 1)
    assert [o for o, _, _, _ in found.ops][-2:] == [pt.HOST, pt.HOST]


def test_a_program_without_tables_or_spans_reads_none(monkeypatch):
    """The parent commit's program: no tables in its module, no spans in
    its trace; every new reader returns None and none raises."""
    spec = Spec()
    new = [m for m in spec.doc["per_layer"]
           if "exposed_host" in m["name"] or "stage_ms" in m["name"]
           or m["name"].split(".")[1].startswith(("optimizer", "gelu",
                                                   "batchnorm"))]
    assert len(new) == 12
    bare = _trace()
    bare.host = [h for h in bare.host if pt.parse(h[0]) is None]
    for mod in (None, SimpleNamespace()):
        if mod is None:
            monkeypatch.delitem(sys.modules, pt.PROFILING, raising=False)
        else:
            monkeypatch.setitem(sys.modules, pt.PROFILING, mod)
        for t in (_trace(), bare):
            for m in new:
                got = spec.reader(m).read({"trace": t})
                if m["name"] == "serve.stage_ms_per_request" and t is not bare:
                    assert got == pytest.approx(0.2e-3)
                else:
                    assert got is None, m["name"]
        assert spec.reader(new[0]).read({}) is None


@pytest.mark.card
@pytest.mark.parametrize("cell", TRAIN)
def test_a_traced_replay_is_its_tables_nodes(cell, card):
    """At the cell's own size on the card: each replay's operations in a
    traced stretch are its capture table's nodes, one for one; the
    optimizer's counter equals the operations put down to ``adam``; the
    scopes' device time is no more than the device's."""
    import time

    from benchcore.cell import Context

    spec = Spec()
    c = spec.cell(cell)
    cfg, mix = spec.config(c), spec.traffic(c)
    ctx = Context(c, cfg, mix, 2147483989, 2.0, True, card,
                  time.perf_counter())
    record = spec.driver(mix).run(ctx)
    t = record["trace"]
    tabs = pt.tables()
    found = pt.attribute(t, tabs)
    # the profiler may lose a record now and then: one replay at most
    assert found is not None and found.replays == t.units, _why(t, tabs)
    assert found.mapped >= found.replays - 1, _why(t, tabs)
    ops = found.ops
    replays = [ids for k, ids, _, _ in pt.spans(t) if k == "graph.replay"]
    total = sum(tabs[int(ids["graph"])].total for ids in replays)
    mapped = sum(o not in (pt.HOST, pt.UNMAPPED) for o, _, _, _ in ops)
    assert mapped == total * found.mapped // found.replays
    adam = sum(o == "adam" for o, _, _, _ in ops)
    assert pt.scope_ops(record, "adam") * found.mapped == adam > 0
    scoped = sum(e - s for o, s, e, _ in ops if o not in (pt.HOST,
                                                         pt.UNMAPPED))
    assert scoped <= sum(e - s for _, s, e in t.device)
    assert record["numbers"]["eager_steps"] == 0


def _why(t, tabs) -> dict:
    """What the attribution of ``t`` found, for a failure's message."""
    replays = [(s, ids) for k, ids, s, _ in pt.spans(t) if k == "graph.replay"]
    ops = sorted(t.device, key=lambda r: (r[1], r[2]))
    calls = sorted(s for n, s, _ in t.host if pt.LAUNCH.match(n))
    out = {"ops": len(ops), "calls": len(calls), "replays": len(replays),
           "tables": {i: (x.total, x.error) for i, x in tabs.items()},
           "apis": sorted({n for n, _, _ in t.host if n.startswith("cu")})}
    placed = 0
    for start, ids in replays:
        table = tabs.get(int(ids.get("graph", -1)))
        if table is None or table.rows is None:
            out["no_table"] = ids
            break
        first = __import__("bisect").bisect_left(calls, start) + placed
        block = ops[first:first + table.total]
        got = "".join(pt._letter(n) for n, _, _ in block)
        bad = next((i for i, (x, y) in enumerate(zip(got, table.types))
                    if x != y), None)
        if len(block) != table.total or bad is not None or \
                block[0][1] < start:
            out["replay"] = {"first": first, "len": len(block),
                             "early": block[0][1] - start, "at": bad,
                             "names": [n[:40] for n, _, _ in
                                       block[max(0, (bad or 0) - 2):
                                             (bad or 0) + 2]],
                             "want": table.types[max(0, (bad or 0) - 2):
                                                 (bad or 0) + 2]}
            break
        placed += table.total
    return out
