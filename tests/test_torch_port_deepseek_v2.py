"""DeepSeek-V2 as the port's text-stimulus encoder
(``features/deepseek_v2_model.py``, ``features/text_llm.py``) against the
benchmark's plain reference (``benchmark/reference/deepseek_v2.py``, which
imports nothing of the port), on the CPU at a tiny size: hidden 64, 4
heads (nope 16, rope 8, v 16), latent 32, 8 routed experts top-2 of width
32, 2 shared, 3 layers of which the first is dense, a vocabulary of 512,
YaRN as DeepSeek-V2-Lite's.  Weights N(0, 0.15²) (norms ones), larger
than a fresh model's 0.02 so that attention is not near-uniform and a
wrong scale or rope shows.

Also: a document in chunks through the latent cache against one chunk
over the whole document; YaRN's frequencies and the attention scale
against their closed form; the route kernel's plain version against
``torch.topk`` (ties included), its permutation and counter; the
combine; each planted fault of the benchmark (``benchmark/benchcore/
faults_llm.py``) moves the output or the routing past a sound run's; the
checkpoint loader's key names; the scopes and spans.

Marked ``card`` (skipped without an NVIDIA card; on the card:
``python -m pytest --noconftest tests/test_torch_port_deepseek_v2.py -m
card``): the route and combine kernels against their plain versions.
This file imports no JAX."""

import json
import math
import os
import struct
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meg_decoding_tpu_torch.features import deepseek_v2_model as dm
from meg_decoding_tpu_torch.features import hf_checkpoint, text_llm
from meg_decoding_tpu_torch.ops.kernels import moe as mk
from meg_decoding_tpu_torch.utils import profiling

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchcore.faults_llm import FAULTS, planted  # noqa: E402
from reference import deepseek_v2 as ref  # noqa: E402

TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, n_routed_experts=8, n_shared_experts=2,
            num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16)
CFG = dm.DeepseekV2Config(**TINY)
M = {**TINY, "first_k_dense_replace": 1, "moe_layer_freq": 1,
     "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
     "rope_scaling": dm.DSV2_LITE.rope_scaling}
CHUNK, CACHE = 16, 128
SCALE = 0.15


def _model(dtype=torch.float32, seed=3) -> dm.DeepseekV2Model:
    m = dm.DeepseekV2Model(CFG, dtype).eval().requires_grad_(False)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if not name.endswith("norm.weight"):
                p.normal_(0.0, SCALE, generator=g)
    return m


def _weights(model):
    w = {k: v.detach() for k, v in model.named_parameters()}
    return lambda name: w[name]


def _doc(n: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, TINY["vocab_size"], (n,), generator=g)
    lens = torch.randint(1, 4, (n,), generator=g).cumsum(0)
    ends = lens[lens < n].tolist() + [n]
    return ids, np.asarray(ends)


def _embed(model, ids, ends, chunk=CHUNK):
    return text_llm.embed_words_last4_avg(model, ids, ends, chunk, CACHE)


def _gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.mark.parametrize("n", [11, 48, 100])  # one chunk, exact, padded
def test_embedding_matches_the_reference(model, n):
    """f32 program against the f32 reference: ≤ 1e-5 of the largest
    feature (the two sum in other orders: blocked vs flash-free attention,
    grouped vs per-expert products)."""
    ids, ends = _doc(n, n)
    got = _embed(model, ids, ends)
    want, info = ref.embed_words(_weights(model), M, ids, ends)
    assert got.shape == want.shape == (64, len(ends))
    assert _gap(got, want) <= 1e-5
    own = torch.stack(info["routes"]).sort(-1).values
    assert torch.equal(model.route_ids[:, :n].long().sort(-1).values, own)


def test_bf16_matches_the_reference_routed_as_it_routed():
    """bf16 program against the f32 reference given the program's routing:
    ≤ 3e-2 of the largest feature (bf16 keeps 8 bits; three layers of
    rounding at every product and residual add read 1.0–1.9e-2 over eight
    seeds here), and the routing within 2e-2 of the reference's own
    probabilities (bf16's hidden states move router logits of std ~1.2 by
    ~1e-2 at this size, so near-ties flip: 0–9e-3 over the seeds)."""
    m = _model(torch.bfloat16)
    ids, ends = _doc(90, 5)
    got = _embed(m, ids, ends)
    routes = list(m.route_ids[:, :90])
    want, info = ref.embed_words(_weights(m), M, ids, ends, routes)
    assert _gap(got, want) <= 3e-2
    assert info["route_gap"] <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunks_through_the_cache_are_the_whole_document(dtype):
    """Chunks of 16 through the latent cache against one chunk of 128 over
    the whole document: the same features (f32 within 1e-6 of the
    largest: products of other heights sum in other orders), the same
    routing, and the counter holds each real token's k experts once."""
    m = _model(dtype)
    ids, ends = _doc(100, 7)
    parts = _embed(m, ids, ends, CHUNK)
    routes, counts = m.route_ids[:, :100].clone(), m.expert_counts.clone()
    whole = _embed(m, ids, ends, CACHE)
    assert _gap(parts, whole) <= (1e-6 if dtype == torch.float32 else 1e-2)
    if dtype == torch.float32:
        assert torch.equal(routes, m.route_ids[:, :100])
        assert torch.equal(counts, m.expert_counts)
    assert counts.sum(1).tolist() == [100 * 2] * 2


def test_yarn_frequencies_and_scale_match_their_closed_form():
    """DeepSeek-V2-Lite's YaRN (θ 10,000, factor 40, original 4,096, β 32
    and 1) in f64 from its formulas: inv_freq blends θ^(−2i/d)/40 into
    θ^(−2i/d) over the ramp between the correction dims; the scale is
    192^−½·m², m = 0.1·0.707·ln 40 + 1."""
    cfg, d, base = dm.DSV2_LITE, 64, 10000.0

    def corr(rot):
        return d * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), d - 1)
    want = []
    for i in range(d // 2):
        extra = base ** (-2 * i / d)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(extra / 40 * ramp + extra * (1 - ramp))
    got = dm.rope_inv_freq(cfg).double()
    assert torch.allclose(got, torch.tensor(want, dtype=torch.float64),
                          rtol=1e-6, atol=0)
    assert torch.equal(ref.inv_freq(dict(M, qk_rope_head_dim=64)),
                       dm.rope_inv_freq(cfg))
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.2608, abs=1e-4)
    assert dm.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m,
                                                  rel=1e-12)
    assert dm.rope_mscale(cfg) == 1.0


def _route(logits, k, n_valid=None):
    T, E = logits.shape
    counter = torch.zeros(E, dtype=torch.int32)
    nv = torch.tensor([T if n_valid is None else n_valid], dtype=torch.int32)
    return (*mk.moe_route(logits, k, nv, counter), counter)


@pytest.mark.parametrize("ties", [False, True])
def test_route_takes_the_top_k_as_topk_does(ties):
    """The plain route's weights are ``torch.topk``'s values of the f32
    softmax, its experts topk's set; where probabilities tie, the lower
    expert goes first (a greedy argmax; topk's order among ties is not
    defined, so its values are compared)."""
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(200, 64, generator=g)
    if ties:
        logits = (logits * 2).round() / 2  # many exact ties
    w, ids, _, _, _, _ = _route(logits, 6)
    p = torch.softmax(logits, -1)
    top = torch.topk(p, 6, dim=-1)
    assert torch.equal(w, top.values)
    assert torch.equal(p.gather(1, ids.long()), w)
    for t in range(200):
        for r in range(5):
            if w[t, r] == w[t, r + 1]:
                assert ids[t, r] < ids[t, r + 1]
    if not ties:
        assert torch.equal(ids.long().sort(-1).values,
                           top.indices.sort(-1).values)


def test_route_sorts_the_pairs_by_expert_and_counts_the_valid_tokens():
    logits = torch.randn(37, 8, generator=torch.Generator().manual_seed(2))
    w, ids, offs, pos, token, counter = _route(logits, 3, n_valid=30)
    flat = ids.reshape(-1).long()
    assert offs.tolist() == \
        torch.bincount(flat, minlength=8).cumsum(0).tolist()
    assert sorted(pos.reshape(-1).tolist()) == list(range(37 * 3))
    # row pos[t, r] holds token t, inside its expert's rows, in token order
    assert torch.equal(token[pos.reshape(-1).long()],
                       torch.arange(37).repeat_interleave(3).int())
    starts = torch.cat([torch.zeros(1, dtype=torch.int32), offs[:-1]])
    assert bool(((pos >= starts[ids.long()]) & (pos < offs[ids.long()])).all())
    for a, b in zip(starts.tolist(), offs.tolist()):
        rows = token[a:b]
        assert bool((rows[1:] >= rows[:-1]).all())
    assert counter.tolist() == torch.bincount(ids[:30].reshape(-1).long(),
                                              minlength=8).int().tolist()


def test_combine_is_the_weighted_sum_plus_the_shared_rows():
    g = torch.Generator().manual_seed(3)
    ys = torch.randn(12, 16, generator=g).bfloat16()
    pos = torch.randperm(12, generator=g).reshape(4, 3).int()
    w = torch.rand(4, 3, generator=g)
    shared = torch.randn(4, 16, generator=g).bfloat16()
    acc = sum(ys[pos[:, r].long()].float() * w[:, r, None] for r in range(3))
    want = (acc.bfloat16().float() + shared.float()).bfloat16()
    assert torch.equal(mk.moe_combine(ys, pos, w, shared), want)
    assert torch.equal(mk.moe_combine(ys, pos, w), acc.bfloat16())


@pytest.mark.parametrize("fault", FAULTS)
def test_every_fault_moves_the_output_or_the_routing(fault):
    """Each fault of the benchmark's cell, planted in the bf16 program,
    reads past 1e-1 in output or route gap against the reference routed
    as the program routed (0.12–1.3 over two seeds); the sound program
    reads under 3e-2 and 2e-2
    (``test_bf16_matches_the_reference_routed_as_it_routed``)."""
    ids, ends = _doc(90, 5)
    with planted(fault):
        m = _model(torch.bfloat16)
        got = _embed(m, ids, ends)
    routes = list(m.route_ids[:, :90])
    want, info = ref.embed_words(_weights(m), M, ids, ends, routes)
    assert max(_gap(got, want), info["route_gap"]) > 1e-1


def _write_safetensors(path, tensors):
    header, blobs, at = {}, [], 0
    for name, t in tensors.items():
        b = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_a_sharded_checkpoint_loads_by_transformers_names(tmp_path):
    """A synthetic ``DeepseekV2ForCausalLM`` checkpoint: ``model.``-prefixed
    names, an LM head and a rotary buffer, in two safetensors shards with
    their index; ``load_text_llm(backend="hf")`` loads every weight in
    place (each routed expert's into its view of the stacked tensors)."""
    src = _model(torch.bfloat16, seed=9)
    sd = {"model." + k: v.clone() for k, v in src.state_dict().items()}
    sd["lm_head.weight"] = torch.zeros(512, 64, dtype=torch.bfloat16)
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.ones(
        4, dtype=torch.bfloat16)
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[::2],
              "model-00002-of-00002.safetensors": names[1::2]}
    for shard, keys in shards.items():
        _write_safetensors(tmp_path / shard, {k: sd[k] for k in keys})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {k: s for s, ks in shards.items()
                                  for k in ks}}, f)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({**M, "q_lora_rank": None, "topk_method": "greedy",
                   "scoring_func": "softmax", "model_type": "deepseek_v2"}, f)
    assert set(hf_checkpoint.read_state_dict(str(tmp_path))) == set(sd)
    got = text_llm.load_text_llm(str(tmp_path), backend="hf", device="cpu")
    for k, v in src.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    moe = got.layers[1].mlp
    assert torch.equal(moe.w13[3, :32], src.layers[1].mlp.experts[3]
                       .gate_proj.weight)
    with pytest.raises(KeyError):
        hf_checkpoint.deepseek_v2_params_from_hf(
            {k: v for k, v in sd.items() if "experts.5." not in k}, got)


def test_the_chunk_graph_records_the_scopes_and_the_spans():
    """One chunk forward a model, one program a chunk position; its table
    (on the CPU the first eager run records the scopes' order) holds the
    MLA, route, experts and shared scopes of each layer; under
    torch.profiler each call is one ``llm.embed`` range holding one
    ``llm.chunk`` range a chunk, each over its ``graph.replay``."""
    m = _model(torch.bfloat16, seed=4)
    ids, ends = _doc(40, 1)
    before = {t.id for t in profiling.tables.values()}
    _embed(m, ids, ends)
    graphed = text_llm.chunk_forward(m)
    assert text_llm.chunk_forward(m) is graphed
    assert len(graphed.programs) == 3 and graphed.kind == "forward"
    new = [t for t in profiling.tables.values() if t.id not in before]
    assert len(new) == 3
    moe = ["mla", "moe_route", "moe_experts", "moe_shared", "moe_experts"]
    for table in new:
        assert set(table.entries) <= set(profiling.SCOPES)
        assert table.entries == (["mla", "moe_shared"] + moe * 2 + ["last4"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _embed(m, ids, ends)
    events = sorted(((e.name, e.time_range.start) for e in prof.events()
                     if e.name.startswith(("llm.", "graph.replay"))),
                    key=lambda r: r[1])
    names = [n.split("#")[0] for n, _ in events]
    assert names == ["llm.embed"] + ["llm.chunk", "graph.replay"] * 3
    assert mk.launches == {"moe_route": 0, "moe_combine": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("T, E, k", [(2048, 64, 6), (37, 8, 2), (1, 256, 8)])
def test_route_kernel_is_its_plain_version_on_the_card(card, T, E, k):
    """Ids, offsets, rows and tokens exactly; weights within 4 f32 ulp of
    the plain softmax (its sum runs in another order); the counter by the
    valid tokens alone."""
    g = torch.Generator(device=card).manual_seed(T)
    logits = torch.randn(T, E, device=card, generator=g)
    nv = torch.tensor([max(T - 5, 1)], dtype=torch.int32, device=card)
    c1 = torch.zeros(E, dtype=torch.int32, device=card)
    c2 = torch.zeros(E, dtype=torch.int32)
    got = mk.moe_route(logits, k, nv, c1)
    want = mk.moe_route_plain(logits.cpu(), k, nv.cpu(), c2)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b)
    assert torch.allclose(got[0].cpu(), want[0], rtol=5e-7, atol=0)
    assert torch.equal(c1.cpu(), c2)


@pytest.mark.card
@pytest.mark.parametrize("shared", [True, False])
def test_combine_kernel_is_its_plain_version_on_the_card(card, shared):
    g = torch.Generator(device=card).manual_seed(5)
    T, k, H = 2048, 6, 2048
    ys = torch.randn(T * k, H, device=card, generator=g).bfloat16()
    pos = torch.randperm(T * k, device=card, generator=g).reshape(T, k).int()
    w = torch.rand(T, k, device=card, generator=g)
    sh = torch.randn(T, H, device=card, generator=g).bfloat16() if shared \
        else None
    got = mk.moe_combine(ys, pos, w, sh)
    want = mk.moe_combine_plain(ys, pos, w, sh)
    assert torch.equal(got, want)
