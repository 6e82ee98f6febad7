"""The speech-embedding cell (``drivers/embed_closed_loop.py``) and the
throughput cell on the CPU at small shapes: each comes out correct through
``run.main``; each fault of ``benchcore/faults_w2v.py`` makes the
embedding cell not correct; the reference's chunk plan covers every frame
once; the FLOP count equals ``chip_smoke.py``'s."""

import contextlib
import json
import sys

import numpy as np
import pytest
import torch

from cellbench_tiny import SPEECH, TRAIN
from conftest import ROOT

torch.set_num_threads(2)

# real conv geometry, small widths, 2 layers, 1 s chunks with 0.1 s of
# overlap; the ladder's six files have 2 to 7 chunks
W2V = {"model.hidden_size": 32, "model.num_hidden_layers": 2,
       "model.num_attention_heads": 2, "model.intermediate_size": 64,
       "model.conv_dim": [8] * 7, "model.num_conv_pos_embeddings": 16,
       "model.num_conv_pos_embedding_groups": 4, "audio.chunk_sec": 1.0,
       "audio.overlap_sec": 0.1, "traffic.files": 6, "traffic.min_sec": 1.5,
       "traffic.max_sec": 5.6, "traffic.trace_requests": 2}
CELLS = {"w2v_embed_30to120s": W2V,
         "speech_train_throughput_b256": {**SPEECH, **TRAIN,
                                          "traffic.compute_dtype": "float32"}}


def _run(cell, capsys, fault=None, seed=4294967311, trace=0):
    import run
    from benchcore.faults_w2v import planted

    with planted(fault) if fault else contextlib.nullcontext():
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", "0.2", "--trace", str(trace)],
                      device="cpu", config_overrides=CELLS[cell])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_new_cells_come_out_correct(cell, capsys):
    line = _run(cell, capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    if cell == "w2v_embed_30to120s":
        assert set(line["metrics"]) == {"request_ms_p50", "request_ms_p95",
                                        "setup_s"}
        assert line["attempted"] % 6 == 0 and line["attempted"] >= 12
        assert line["checks"]["frames"]["value"] == 0.0


@pytest.mark.parametrize("fault", ["mask_dropped", "stitch_shifted"])
def test_a_fault_in_the_embedding_is_not_correct(fault, capsys):
    line = _run("w2v_embed_30to120s", capsys, fault)
    assert line["correct"] is False
    assert line["checks"]["output"]["value"] > \
        line["checks"]["output"]["limit"]
    assert line["checks"]["frames"]["value"] == 0.0


def test_the_traced_run_reads_the_request_mfu(capsys):
    """On the CPU the trace holds no device operation, so the readers of
    the device trace and of the program's spans find nothing; the MFU is
    read from the untraced window."""
    line = _run("w2v_embed_30to120s", capsys, trace=1)
    assert set(line["metrics"]) == {"w2v.request_mfu"}
    assert line["metrics"]["w2v.request_mfu"]["value"] > 0


@pytest.mark.parametrize("seconds", [30.0, 37.9, 38.0, 56.0, 120.0, 743.3])
def test_the_reference_plan_takes_every_frame_once(seconds):
    from benchcore.spec import Spec
    from reference import wav2vec2 as ref

    spec = Spec()
    m = spec.config(spec.cell("w2v_embed_30to120s"))["model"]
    n = int(seconds * 16000)
    plan = ref.chunk_plan(m, n, 20.0, 1.0, 16000)
    frames = [f for _, first, stop in plan for f in range(first, stop)]
    assert frames == list(range(ref.num_frames(m, n)))
    for start, first, stop in plan[1:]:
        # every kept frame lies 50 frames (1 s) or more inside its chunk
        g0 = start // 320
        assert first - g0 >= 50 and (stop == frames[-1] + 1
                                     or g0 + 999 - stop >= 50)


def test_the_ladder_has_the_chunk_counts_it_promises():
    import drivers.embed_closed_loop as ec
    from benchcore.spec import Spec

    spec = Spec()
    cell = spec.cell("w2v_embed_30to120s")
    cfg, mix = spec.config(cell), spec.traffic(cell)
    lengths = [int(round(s * 16000)) for s in
               np.linspace(mix["min_sec"], mix["max_sec"], mix["files"])]
    counts = [ec.chunks_of(cfg, n) for n in lengths]
    assert {c: counts.count(c) for c in set(counts)} == \
        {2: 3, 3: 6, 4: 7, 5: 6, 6: 6, 7: 4}


def test_w2v_flops_equal_chip_smoke_count():
    sys.path.insert(0, ROOT)
    import chip_smoke
    from benchcore.counts_w2v import w2v_flops
    from benchcore.spec import Spec
    from meg_decoding_tpu_torch.features.wav2vec2_model import Wav2Vec2Config

    spec = Spec()
    m = spec.config(spec.cell("w2v_embed_30to120s"))["model"]
    cfg = Wav2Vec2Config.from_dict(m)
    for n in (320000, 48000, 742 * 16000):
        for layers in (True, False):
            assert w2v_flops(m, n, layers) == \
                chip_smoke.w2v_flops(cfg, n, layers)
    # one 20 s chunk: 817.5 GFLOP
    assert w2v_flops(m, 320000) == pytest.approx(817.5e9, rel=1e-3)


@pytest.mark.card
def test_control_and_faults_are_not_correct_on_the_card(card):
    """At the cell's own size on three seeds: the TF32 control and each
    fault of ``benchcore/faults_w2v.py`` fail ``output``; the program
    passes it."""
    import calibrate_embed
    from benchcore import checks, port_features
    from benchcore.spec import Spec

    spec = Spec()
    c = spec.cell("w2v_embed_30to120s")
    cfg, mix, limits = spec.config(c), spec.traffic(c), spec.limits(c)
    dev = port_features.device(card)
    port_features.build_kernels()
    held = {k: v for k, v in limits.items() if k != "eager_chunks"}
    for seed in (2147483989, 3000000019, 4294967311):
        for what, numbers in calibrate_embed.embed_readings(
                cfg, mix, seed, ["sound", "control", "mask_dropped",
                                 "stitch_shifted"], dev):
            ok, rows = checks.judge(numbers, held)
            assert ok is (what == "sound"), (seed, what, rows)
