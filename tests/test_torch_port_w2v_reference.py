"""The port's speech embedding (``features/wav2vec.py:embed_last4_avg``,
each chunk through its ``GraphedStep``, which runs eagerly on the CPU)
against the benchmark's plain reference (``benchmark/reference/
wav2vec2.py``, which imports nothing of the port), on the CPU: seeded
weights at wav2vec2's real conv geometry (kernels (10, 3, 3, 3, 3, 2, 2),
strides (5, 2, 2, 2, 2, 2, 2), so 320 samples a frame), small widths
(8 conv channels, hidden 32, 2 heads, FFN 64, positional conv K = 16 in 4
groups) and 2 layers, 1 s chunks with 0.1 s of overlap.  Every bias,
LayerNorm and ``weight_g`` is drawn at random, so that padded frames are
not zero and a broken mask or weight norm would show.

Three waveforms: one chunk or less (one forward at its own length), an
exact multiple (the last chunk full), and a zero-padded, masked last
chunk.  Tolerance: max |Δ| ≤ 1e-5·max |ref| (f32; the reference writes its
LayerNorms and GELU out and sums in another order).  Then, the chunk
graph's capture table (on the CPU its first eager run records the scopes'
order) and the embedding's spans under ``torch.profiler``."""

import dataclasses
import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meg_decoding_tpu_torch.features import wav2vec
from meg_decoding_tpu_torch.features.wav2vec2_model import XLSR53, Wav2Vec2Model
from meg_decoding_tpu_torch.utils import profiling

torch.set_num_threads(1)

RTOL = 1e-5
SR, CHUNK_SEC, OVERLAP_SEC = 16000, 1.0, 0.1
CHUNK, STEP = 16000, 12480  # samples: a chunk, and between two chunks' starts
M = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
         intermediate_size=64, conv_dim=[8] * 7,
         conv_kernel=list(XLSR53.conv_kernel),
         conv_stride=list(XLSR53.conv_stride), conv_bias=True,
         num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
         layer_norm_eps=1e-5)


def _reference():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "reference", "wav2vec2.py")
    spec = importlib.util.spec_from_file_location("w2v_reference", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ref():
    return _reference()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(
        XLSR53, **{k: tuple(v) if isinstance(v, list) else v
                   for k, v in M.items()})
    m = Wav2Vec2Model(cfg).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(20)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.normal_(0.0, 0.3, generator=g)
            if name.endswith("layer_norm.weight"):
                p.add_(1.0)
    return m


def _wave(n: int, seed: int) -> torch.Tensor:
    return 0.1 * torch.randn(n, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n, chunks, last_full", [
    (int(0.83 * SR), 1, True),         # one chunk or less: its own length
    (2 * STEP + CHUNK, 3, True),       # an exact multiple: the last chunk full
    (2 * STEP + CHUNK + 4321, 4, False),  # a zero-padded, masked last chunk
])
def test_embedding_matches_the_reference(model, ref, n, chunks, last_full):
    wav = _wave(n, n)
    got = wav2vec.embed_last4_avg(model, wav, CHUNK_SEC, OVERLAP_SEC, SR)
    w = {k: v.detach() for k, v in model.named_parameters()}
    want = ref.embed(w, M, wav, CHUNK_SEC, OVERLAP_SEC, SR)
    assert got.shape == want.shape == (32, ref.num_frames(M, n))
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())
    plan = ref.chunk_plan(M, n, CHUNK_SEC, OVERLAP_SEC, SR)
    assert len(plan) == chunks
    if chunks > 1:
        ov = round(OVERLAP_SEC * SR / 320)
        port_plan = wav2vec._chunk_plan(model.config, n, CHUNK, ov)
        assert len(port_plan) == chunks
        start, end, _, _ = port_plan[-1]
        assert (end - start == CHUNK) == last_full


def test_one_chunk_forward_per_model_records_the_scopes_in_order(model):
    """The chunk graph's table: the conv stack (each of its GELUs in
    ``gelu``), the projection, the positional conv and its GELU, then each
    layer's attention and feed-forward (its GELU inside), the last-four
    mean; one graph for every chunk of one size."""
    wav2vec._graphs.pop(model, None)
    before = {t.id for t in profiling.tables.values()}
    wav2vec.embed_last4_avg(model, _wave(3 * STEP, 1), CHUNK_SEC,
                            OVERLAP_SEC, SR)
    graphed = wav2vec.chunk_forward(model)
    assert wav2vec.chunk_forward(model) is graphed
    assert len(graphed.programs) == 1 and graphed.kind == "forward"
    (table,) = [t for t in profiling.tables.values() if t.id not in before]
    assert table.kind == "forward" and table.rows is None
    assert set(table.entries) <= set(profiling.SCOPES)
    layer = ["attention", "ffn", "gelu"]
    assert table.entries == (["w2v_conv"] + ["gelu"] * 7 + ["w2v_conv",
                             "w2v_pos_conv", "gelu"] + layer * 2 + ["last4"])


def test_embedding_spans_carry_their_request_and_chunks(model):
    """Under torch.profiler: one ``w2v.embed`` host range a call (its
    ``request=`` id) holding one ``w2v.chunk`` range a chunk, each over its
    graph's ``graph.replay``; a short waveform has no chunk span."""
    long, short = _wave(2 * STEP + CHUNK + 99, 2), _wave(CHUNK // 2, 3)
    # the chunk graph's first run records its table (no replay span)
    wav2vec.embed_last4_avg(model, long, CHUNK_SEC, OVERLAP_SEC, SR)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wav2vec.embed_last4_avg(model, long, CHUNK_SEC, OVERLAP_SEC, SR)
        wav2vec.embed_last4_avg(model, short, CHUNK_SEC, OVERLAP_SEC, SR)
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(("w2v.", "graph.replay"))),
                    key=lambda r: r[1])
    embeds = [r for r in events if r[0].startswith("w2v.embed#request=")]
    chunks = [r for r in events if r[0].startswith("w2v.chunk#chunk=")]
    replays = [r for r in events if r[0].startswith("graph.replay")]
    assert len(embeds) == 2 and len(chunks) == len(replays) == 4
    ids = [int(r[0].split("=")[1]) for r in embeds]
    assert ids[1] == ids[0] + 1
    first = embeds[0]
    assert all(first[1] <= s and e <= first[2] for _, s, e in chunks)
    for (_, s, e), (_, rs, re_) in zip(chunks, replays):
        assert s <= rs and re_ <= e
    chunk_ids = [int(r[0].split("=")[1]) for r in chunks]
    assert chunk_ids == list(range(chunk_ids[0], chunk_ids[0] + 4))
