"""Kimi-Linear as the port's second text-stimulus encoder
(``features/kimi_linear_model.py``, ``features/text_llm.py``,
``ops/kernels/kda.py``, the sigmoid route of ``ops/kernels/moe.py``)
against the benchmark's plain reference (``benchmark/reference/
kimi_linear.py``, which imports nothing of the port), on the CPU at a tiny
size: hidden 64, one period of KDA, KDA, KDA, MLA and one more KDA layer
(layer 0 dense, the others MoE), KDA heads 4 × 16 with a convolution of
4, MLA 4 heads (nope 16, rope 8, v 16, latent 32), 16 routed experts
top-4 of width 32 and one shared, a vocabulary of 512.  Weights N(0,
0.15²) (the convolutions' N(0, 0.5²), norms ones, ``A_log`` and
``dt_bias`` as ``init_random`` draws them), larger than a fresh model's
0.02 so that attention is not near-uniform and a fault shows.

Also: the chunked KDA form against the token recurrence, the state and
convolution tails carried across chunk boundaries, chunks that are not a
multiple of 64; the share test (two halves of the experts add up to the
uncut layer); the sigmoid/bias/held route's plain version against a direct
``topk``; DeepSeek-V2's softmax route as it was; the chunk graph's route
against the eager one; the scopes; each planted fault of the benchmark
(``benchmark/benchcore/faults_kimi.py``); the checkpoint loader.

Marked ``card`` (skipped without an NVIDIA card; on the card:
``python -m pytest --noconftest tests/test_torch_port_kimi_linear.py -m
card``): the KDA kernel and the sigmoid/held route and combine against
their plain versions.  This file imports no JAX."""

import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

from meg_decoding_tpu_torch.features import deepseek_v2_model as dm
from meg_decoding_tpu_torch.features import kimi_linear_model as km
from meg_decoding_tpu_torch.features import text_llm
from meg_decoding_tpu_torch.ops.kernels import kda
from meg_decoding_tpu_torch.ops.kernels import moe as mk
from meg_decoding_tpu_torch.utils import profiling

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from benchcore.faults_kimi import FAULTS, planted  # noqa: E402
from reference import kimi_linear as ref  # noqa: E402

LA = {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5], "head_dim": 16,
      "num_heads": 4, "short_conv_kernel_size": 4}
TINY = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
            moe_intermediate_size=32, num_hidden_layers=5,
            num_attention_heads=4, num_experts=16, num_experts_per_token=4,
            num_shared_experts=1, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, linear_attn_config=LA)
M = {**TINY, "first_k_dense_replace": 1, "moe_layer_freq": 1,
     "rms_norm_eps": 1e-5, "routed_scaling_factor": 2.446,
     "moe_renormalize": True}
CHUNK, CACHE = 16, 64


def _model(dtype=torch.float32, seed=3, **held) -> km.KimiLinearModel:
    m = km.KimiLinearModel(km.KimiLinearConfig(**TINY, **held), dtype)
    m.eval().requires_grad_(False)
    g = torch.Generator().manual_seed(seed)
    m.init_random(g)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if "conv1d" in name:
                p.normal_(0.0, 0.5, generator=g)
            elif name.endswith(".weight") and not name.endswith("norm.weight"):
                p.normal_(0.0, 0.15, generator=g)
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


def test_the_parameters_are_the_references_by_name(model):
    """The program's parameters are ``param_spec``'s names and shapes, the
    MLA layer at 0-based 3, the KDA layers elsewhere, layer 0 dense."""
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    want = {n: tuple(s) for n, s, _ in ref.param_spec(M)}
    assert got == want
    assert model.config.kda_layers == ref.kda_layers(M) == [0, 1, 2, 4]
    assert model.config.mla_layers == [3]
    assert model.config.moe_layers == ref.moe_layers(M) == [1, 2, 3, 4]


@pytest.mark.parametrize("n", [11, 48, 40])  # one chunk, exact, 3 padded
def test_embedding_matches_the_reference(model, n):
    """f32 program against the f32 reference (the token recurrence): ≤ 1e-5
    of the largest feature (chunked vs token-by-token delta rule, blocked
    vs flash-free attention, grouped vs per-expert products sum in other
    orders: 1e-6 here), and the same routing."""
    ids, ends = _doc(n, n)
    got = _embed(model, ids, ends)
    want, info = ref.embed_words(_weights(model), M, ids, ends)
    assert got.shape == want.shape == (64, len(ends))
    assert _gap(got, want) <= 1e-5
    own = torch.stack(info["routes"]).sort(-1).values
    assert torch.equal(model.route_ids[:, :n].long().sort(-1).values, own)
    assert info["route_gap"] == 0.0


def test_bf16_matches_the_reference_routed_as_it_routed():
    """bf16 program against the f32 reference given the program's routing,
    over 3 chunks (the last padded): ≤ 6e-2 of the largest feature (five
    layers of bf16 rounding at every product, residual add, convolution
    and the KDA kernel's bf16 intermediates: 1.6–4.7e-2 over eight seeds
    here), the routing within 4e-2 of the reference's own choice scores
    (bf16 hidden states move the sigmoid scores of 16 experts, top-4, by
    ~1e-2, so near-ties flip: 1.1–2.7e-2 over the seeds)."""
    m = _model(torch.bfloat16)
    ids, ends = _doc(40, 5)
    got = _embed(m, ids, ends)
    routes = list(m.route_ids[:, :40])
    want, info = ref.embed_words(_weights(m), M, ids, ends, routes)
    assert _gap(got, want) <= 6e-2
    assert info["route_gap"] <= 4e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunks_carry_the_state_and_the_tails(dtype):
    """Chunks of 16 against one chunk of 64 over the whole document: the
    KDA state and the convolutions' tails carried from chunk to chunk give
    the same features (f32 within 1e-5 of the largest) and, in f32, the
    same routing; the counter holds each real token's k experts once."""
    m = _model(dtype)
    ids, ends = _doc(50, 7)
    parts = _embed(m, ids, ends, CHUNK)
    routes, counts = m.route_ids[:, :50].clone(), m.expert_counts.clone()
    whole = _embed(m, ids, ends, CACHE)
    assert _gap(parts, whole) <= (1e-5 if dtype == torch.float32 else 5e-2)
    if dtype == torch.float32:
        assert torch.equal(routes, m.route_ids[:, :50])
        assert torch.equal(counts, m.expert_counts)
    assert counts.sum(1).tolist() == [50 * 4] * 4


def test_a_document_longer_than_the_cache_raises(model):
    ids, ends = _doc(CACHE + 1, 2)
    with pytest.raises(ValueError, match="cache"):
        _embed(model, ids, ends)


def _kda_inputs(C, H, d, seed, decay=2.0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(C, H, d, generator=g) for _ in range(3))
    gg = -torch.rand(C, H, d, generator=g) * decay
    b = torch.rand(C, H, generator=g)
    return q, k, v, gg, b


@pytest.mark.parametrize("sizes", [(64,), (100,), (30, 64, 37), (1, 150)])
def test_the_chunked_form_is_the_token_recurrence(sizes):
    """kda_chunk's plain chunked form (sub-chunks of 64, the last short)
    over consecutive chunks of these lengths, the state carried in place,
    against the token recurrence over the whole: outputs and final state
    within 1e-5 of their largest (f32; other summation orders)."""
    q, k, v, g, b = _kda_inputs(sum(sizes), 3, 16, sum(sizes))
    s0 = torch.randn(3, 16, 16, generator=torch.Generator().manual_seed(1))
    s1, s2 = s0.clone(), s0.clone()
    want = kda.kda_recurrent(q, k, v, g, b, s1)
    got, at = [], 0
    for n in sizes:
        sl = slice(at, at + n)
        got.append(kda.kda_chunk(q[sl], k[sl], v[sl], g[sl], b[sl], s2))
        at += n
    assert _gap(torch.cat(got), want) <= 1e-5
    assert _gap(s2, s1) <= 1e-5


def test_the_chunked_form_survives_strong_decay():
    """Decays of up to 40 a token (e^−2560 over a sub-chunk, far past f32's
    range) give finite outputs equal to the recurrence's within 1e-4 of
    the largest (1.1e-5 here: the state keeps little beyond the current
    token, so the outputs are small beside the rounding of the forms'
    other sums): every exponent the chunked form takes is ≤ 0."""
    q, k, v, g, b = _kda_inputs(128, 2, 16, 3, decay=40.0)
    s1, s2 = torch.zeros(2, 16, 16), torch.zeros(2, 16, 16)
    want = kda.kda_recurrent(q, k, v, g, b, s1)
    got = kda.kda_chunk(q, k, v, g, b, s2)
    assert torch.isfinite(got).all()
    assert _gap(got, want) <= 1e-4


def test_the_bf16_plain_form_rounds_where_the_kernel_rounds():
    """With bf16 q, k, v the plain form rounds its intermediates to bf16 as
    the kernel does: within 2e-2 of the f32 recurrence (2–4e-3 here), and
    not equal to the f32 form."""
    q, k, v, g, b = _kda_inputs(100, 3, 16, 4)
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    s1, s2, s3 = (torch.zeros(3, 16, 16) for _ in range(3))
    want = kda.kda_recurrent(q, k, v, g, b, s1)
    got = kda.kda_chunk(q, k, v, g, b, s2)
    f32 = kda.kda_chunk_plain(q.float(), k.float(), v.float(), g, b, s3)
    assert got.dtype == torch.bfloat16
    assert _gap(got.float(), want) <= 2e-2
    assert _gap(f32, want) <= 1e-5 < _gap(got.float(), want)


def test_the_kda_layer_carries_its_convolution_tail():
    """One KDA layer over a document in chunks of 5, 16, 1 and 2 tokens
    (the tail holds the last 3 projections, some of an earlier chunk when
    a chunk is shorter than the tail) against the layer over the whole."""
    layer = _model().layers[0].self_attn
    x = torch.randn(24, 64, generator=torch.Generator().manual_seed(6))
    state, tail = torch.zeros(4, 16, 16), torch.zeros(3, 192)
    whole = layer(x, dm._Chunk(0, 24, None, None, None), state, tail)
    parts, at = [], 0
    for n in (5, 16, 1, 2):
        ctx = dm._Chunk(at, at + n, None, None, None)
        parts.append(layer(x[at:at + n], ctx, state, tail))
        at += n
    assert _gap(torch.cat(parts), whole) <= 1e-5


def test_the_two_halves_of_the_experts_add_up_to_the_uncut_layer():
    """The share test: the MoE layer holding experts 0–7 and the one
    holding 8–15, with the same weights, give partial outputs that, with
    the shared expert counted once, add up to the reference's uncut layer
    (every expert held); each half alone does not."""
    full = _model(seed=8)
    halves = [_model(seed=8, experts_first=f, experts_held=8) for f in (0, 8)]
    src = dict(full.named_parameters())
    for h in halves:
        for name, p in h.named_parameters():
            p.copy_(src[name])
    x = torch.randn(30, 64, generator=torch.Generator().manual_seed(9))
    ctx = dm._Chunk(0, 30, None, None, torch.tensor([30], dtype=torch.int32))
    outs = []
    for m in halves:
        moe = m.layers[1].block_sparse_moe
        outs.append(moe(x, ctx, torch.zeros(16, dtype=torch.int32),
                        torch.zeros(30, 4, dtype=torch.int32)))
    shared = halves[0].layers[1].block_sparse_moe.shared_experts(x)
    w = {k: v.detach() for k, v in full.named_parameters()
         if k.startswith("layers.1.block_sparse_moe.")}
    want, _, _ = ref._moe(x, w, "layers.1.block_sparse_moe.", M, None,
                          lambda t: t)
    assert _gap(outs[0] + outs[1] - shared, want) <= 1e-6
    for part in outs:
        assert _gap(part, want) > 1e-2


def _route(logits, k, **kw):
    T, E = logits.shape
    counter = torch.zeros(E, dtype=torch.int32)
    nv = torch.tensor([T], dtype=torch.int32)
    return (*mk.moe_route(logits, k, nv, counter, **kw), counter)


@pytest.mark.parametrize("first, held", [(0, 64), (0, 32), (32, 32), (5, 7)])
def test_the_sigmoid_route_takes_topk_of_score_plus_bias(first, held):
    """Sigmoid scoring: the experts are ``torch.topk``'s of s + bias, the
    weights the chosen s renormalised (+1e-20) and scaled by 2.446; offs
    cover the held experts only, a pair sent elsewhere has pos −1, the
    held pairs' rows are a stable sort by expert, the rows past them
    gather token 0, and the counter holds every expert."""
    g = torch.Generator().manual_seed(first + held)
    logits = torch.randn(200, 64, generator=g)
    bias = torch.randn(64, generator=g) * 0.02
    w, ids, offs, pos, token, counter = _route(
        logits, 8, bias=bias, renormalize=True, scale=2.446, first=first,
        held=held)
    s = torch.sigmoid(logits)
    top = torch.topk(s + bias, 8, dim=-1)
    assert torch.equal(ids.long().sort(-1).values, top.indices.sort(-1).values)
    used = s.gather(1, ids.long())
    want = used / (used.sum(1, keepdim=True) + 1e-20) * 2.446
    assert torch.allclose(w, want, rtol=4e-7, atol=0)
    flat = ids.reshape(-1).long()
    mine = (flat >= first) & (flat < first + held)
    assert offs.tolist() == torch.bincount(
        flat[mine] - first, minlength=held).cumsum(0).tolist()
    p = pos.reshape(-1)
    assert bool((p[~mine] == -1).all())
    n = int(mine.sum())
    assert sorted(p[mine].tolist()) == list(range(n))
    assert torch.equal(token[p[mine].long()],
                       (torch.arange(200 * 8)[mine] // 8).int())
    assert bool((token[n:] == 0).all())
    assert counter.tolist() == torch.bincount(flat, minlength=64).tolist()


def test_the_softmax_route_is_deepseek_v2s():
    """DeepSeek-V2's call (no bias, every expert held) gives what it gave
    before the held range existed: the greedy top-k of the f32 softmax,
    not renormalised, every pair placed by a stable sort by expert."""
    g = torch.Generator().manual_seed(11)
    logits = torch.randn(300, 64, generator=g)
    w, ids, offs, pos, token, counter = _route(logits, 6)
    p = torch.softmax(logits, -1)
    assert torch.equal(w, torch.topk(p, 6, dim=-1).values)
    flat = ids.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    want_pos = torch.empty_like(flat)
    want_pos[order] = torch.arange(flat.numel())
    assert torch.equal(pos.reshape(-1).long(), want_pos)
    assert torch.equal(token.long(), order // 6)
    assert offs.tolist() == torch.bincount(flat, minlength=64).cumsum(
        0).tolist()


def test_the_combine_leaves_out_the_absent_slots():
    g = torch.Generator().manual_seed(3)
    ys = torch.randn(12, 16, generator=g).bfloat16()
    pos = torch.randperm(12, generator=g).reshape(4, 3).int()
    pos[0, 1] = pos[2, 0] = pos[2, 2] = -1
    w = torch.rand(4, 3, generator=g)
    shared = torch.randn(4, 16, generator=g).bfloat16()
    acc = sum(torch.where((pos[:, r] >= 0)[:, None],
                          ys[pos[:, r].clamp(min=0).long()].float()
                          * w[:, r, None], 0.0) for r in range(3))
    want = (acc.bfloat16().float() + shared.float()).bfloat16()
    assert torch.equal(mk.moe_combine(ys, pos, w, shared), want)


def test_the_graph_route_is_the_eager_forward():
    """The chunk forward through ``chunk_forward`` (on the CPU its body on
    the graph's static buffers) equals the model's own forward on the same
    chunks, bit for bit, state and tails carried alike."""
    m = _model(torch.bfloat16, seed=12)
    ids, _ = _doc(32, 4)
    m.allocate(CACHE)
    graphed = text_llm.chunk_forward(m)
    got = []
    for s in (0, 16):
        got.append(graphed({"ids": ids[s:s + 16],
                            "positions": m.positions[:s + 16],
                            "n_valid": torch.tensor([16], dtype=torch.int32)
                            }).clone())
    state = m.kda_state.clone()
    want = []
    for s in (0, 16):
        hs = m(ids[s:s + 16], m.positions[:s + 16])
        want.append(torch.stack([h.float() for h in hs]).mean(0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(state, m.kda_state)


def test_the_chunk_graph_records_the_kda_scope():
    """A chunk's table holds ``kda`` for the four KDA layers, ``mla`` for
    the MLA layer, the dense layer's ``moe_shared`` and the MoE layers'
    scopes, in the layers' order."""
    m = _model(torch.bfloat16, seed=4)
    ids, ends = _doc(20, 1)
    before = {t.id for t in profiling.tables.values()}
    _embed(m, ids, ends)
    new = [t for t in profiling.tables.values() if t.id not in before]
    assert len(new) == 2
    moe = ["moe_route", "moe_experts", "moe_shared", "moe_experts"]
    want = (["kda", "moe_shared"] + ["kda"] + moe + ["kda"] + moe
            + ["mla"] + moe + ["kda"] + moe + ["last4"])
    for table in new:
        assert table.entries == want
    assert kda.launches == {"kda_chunk": 0, "kda_conv": 0}


@pytest.mark.parametrize("fault", FAULTS)
def test_every_fault_moves_the_output_or_the_routing(fault):
    """Each fault of the benchmark's cell, planted in the bf16 program,
    reads past 1e-1 in output or route gap against the reference routed
    as the program routed, over 3 chunks (0.24–1.2 in output, 0.62–0.83 in
    route gap over two seeds); the sound program reads under 6e-2 and 4e-2
    (``test_bf16_matches_the_reference_routed_as_it_routed``)."""
    ids, ends = _doc(40, 5)
    with planted(fault):
        m = _model(torch.bfloat16)
        got = _embed(m, ids, ends)
    routes = list(m.route_ids[:, :40])
    want, info = ref.embed_words(_weights(m), M, ids, ends, routes)
    assert max(_gap(got, want), info["route_gap"]) > 1e-1


def test_the_config_reads_hf_keys_and_refuses_what_it_does_not_implement():
    d = {**M, "model_type": "kimi_linear", "mla_use_nope": True,
         "moe_router_activation_func": "sigmoid", "q_lora_rank": None,
         "num_expert_group": 1, "topk_group": 1, "rope_scaling": None,
         "use_grouped_topk": True}
    cfg = km.KimiLinearConfig.from_dict(d)
    assert cfg.linear_attn_config == LA and cfg.num_experts == 16
    for key, bad in (("mla_use_nope", False), ("num_expert_group", 4),
                     ("moe_router_activation_func", "softmax")):
        with pytest.raises(NotImplementedError):
            km.KimiLinearConfig.from_dict({**d, key: bad})
    assert km.KIMI_LINEAR_48B.kda_layers == [
        i for i in range(27) if i not in (3, 7, 11, 15, 19, 23, 26)]


def _write_safetensors(path, tensors):
    header, blobs, at = {}, [], 0
    for name, t in tensors.items():
        t = t.contiguous()
        b = t.view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": {torch.bfloat16: "BF16",
                                  torch.float32: "F32"}[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [at, at + len(b)]}
        blobs.append(b)
        at += len(b)
    h = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_a_checkpoint_loads_the_held_experts_by_modeling_kimis_names(
        tmp_path):
    """A synthetic ``KimiLinearForCausalLM`` checkpoint (``model.`` names,
    an LM head, all 16 experts) loads into a model holding experts 8–15
    through ``load_text_llm(backend="hf")``: each held expert's w1/w3/w2
    into its views, the others left out."""
    src = _model(torch.bfloat16, seed=9)
    sd = {"model." + k: v.clone() for k, v in src.state_dict().items()}
    sd["lm_head.weight"] = torch.zeros(512, 64, dtype=torch.bfloat16)
    _write_safetensors(tmp_path / "model.safetensors", sd)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({**M, "model_type": "kimi_linear", "mla_use_nope": True,
                   "q_lora_rank": None}, f)
    got = text_llm.load_text_llm(str(tmp_path), backend="hf", device="cpu",
                                 config={"experts_first": 8,
                                         "experts_held": 8})
    assert isinstance(got, km.KimiLinearModel)
    for k, v in got.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    moe = got.layers[2].block_sparse_moe
    assert sorted(int(e) for e in moe.experts.keys()) == list(range(8, 16))
    assert torch.equal(moe.w13[2, 32:], src.layers[2].block_sparse_moe
                       .experts[10].w3.weight)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("C", [2048, 100, 64, 1])
def test_kda_kernel_is_its_plain_version_on_the_card(card, C):
    """The kernel against the plain chunked form (the same bf16 roundings)
    at 32 heads of 128, q, k, v strided as the layer passes them: outputs
    and the f32 state within 1e-2 of their largest (the kernel's f32 sums
    run in other orders and its exponentials are the ex2 unit's, so an
    intermediate now and then rounds to the neighbouring bf16, 2^-8
    apart: 2.8e-3 and 1.1e-3 at 2,048 tokens); for C ≤ 100 both within
    2e-2 of the f32 token recurrence."""
    g = torch.Generator(device=card).manual_seed(C)
    x = torch.randn(C, 3, 32, 128, device=card, generator=g).bfloat16()
    gg = -torch.rand(C, 32, 128, device=card, generator=g) * 0.5
    b = torch.rand(C, 32, device=card, generator=g)
    s0 = torch.randn(32, 128, 128, device=card, generator=g) * 0.1
    s1, s2 = s0.clone(), s0.clone()
    before = kda.launches["kda_chunk"]
    got = kda.kda_chunk(x[:, 0], x[:, 1], x[:, 2], gg, b, s1)
    want = kda.kda_chunk_plain(x[:, 0], x[:, 1], x[:, 2], gg, b, s2)
    torch.cuda.synchronize()
    assert kda.launches["kda_chunk"] == before + 1
    assert _gap(got.float(), want.float()) <= 1e-2
    assert _gap(s1, s2) <= 1e-2
    if C <= 100:
        s3 = s0.clone()
        rec = kda.kda_recurrent(x[:, 0], x[:, 1], x[:, 2], gg, b, s3)
        assert _gap(got.float(), rec) <= 2e-2
        assert _gap(s1, s3) <= 2e-2


@pytest.mark.card
@pytest.mark.parametrize("first, held", [(0, 128), (128, 128), (0, 256)])
def test_the_sigmoid_held_route_is_its_plain_version_on_the_card(card, first,
                                                                 held):
    """Ids, offsets, rows and tokens exactly, weights within 4 f32 ulp, at
    the cell's shape (2,048 tokens, 256 experts, top-8); the combine with
    the absent slots bit for bit."""
    g = torch.Generator(device=card).manual_seed(held + first)
    logits = torch.randn(2048, 256, device=card, generator=g)
    bias = torch.randn(256, device=card, generator=g) * 0.02
    nv = torch.tensor([2040], dtype=torch.int32, device=card)
    c1 = torch.zeros(256, dtype=torch.int32, device=card)
    c2 = c1.clone()
    kw = dict(bias=bias, renormalize=True, scale=2.446, first=first,
              held=held)
    got = mk.moe_route(logits, 8, nv, c1, **kw)
    want = mk.moe_route_plain(logits, 8, nv, c2, **kw)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b.to(a.dtype))
    assert torch.allclose(got[0], want[0], rtol=5e-7, atol=0)
    assert torch.equal(c1, c2)
    ys = torch.randn(2048 * 8, 2304, device=card, generator=g).bfloat16()
    sh = torch.randn(2048, 2304, device=card, generator=g).bfloat16()
    assert torch.equal(mk.moe_combine(ys, got[3], got[0], sh),
                       mk.moe_combine_plain(ys, got[3], got[0], sh))


@pytest.mark.card
@pytest.mark.parametrize("C", [2048, 2, 37])
def test_short_conv_kernel_is_its_plain_version_on_the_card(card, C):
    """The convolution kernel against its plain version at the layer's
    12,288 channels: outputs bit for bit but for SiLU's exponential (an
    ulp of bf16 at most), the carried tail exactly."""
    g = torch.Generator(device=card).manual_seed(C)
    x = torch.randn(C, 12288, device=card, generator=g).bfloat16()
    w = (torch.randn(12288, 1, 4, device=card, generator=g) * 0.5).bfloat16()
    t1 = torch.randn(3, 12288, device=card, generator=g).bfloat16()
    t2 = t1.clone()
    got = kda.short_conv(x, t1, w)
    want = kda.short_conv_plain(x, t2, w)
    torch.cuda.synchronize()
    assert torch.equal(t1, t2)
    assert bool(((got.float() - want.float()).abs()
                 <= 2 ** -7 * want.float().abs() + 1e-30).all())


@pytest.mark.card
def test_the_chunk_graphs_carry_the_state_once_on_the_card(card):
    """A small Kimi-Linear (KDA heads 2 of 128) on the card: a 3-chunk
    document's first pass, which captures each chunk position's graph
    (its warm-up runs the chunk once before the capture), gives the eager
    forward's features: the carried KDA state, tails and counter are put
    back after each warm-up, so each chunk runs once on what the chunk
    before left; the expert counter holds each real token's k experts
    once."""
    la = {"full_attn_layers": [4], "kda_layers": [1, 2, 3, 5],
          "head_dim": 128, "num_heads": 2, "short_conv_kernel_size": 4}
    cfg = km.KimiLinearConfig(
        vocab_size=4096, hidden_size=256, intermediate_size=512,
        moe_intermediate_size=128, num_hidden_layers=5, num_attention_heads=2,
        num_experts=16, num_experts_per_token=4, kv_lora_rank=64,
        experts_held=8, linear_attn_config=la)
    with torch.device(card):
        m = km.KimiLinearModel(cfg).eval().requires_grad_(False)
    m.init_random(torch.Generator(device=card).manual_seed(5))
    ids = torch.randint(0, 4096, (600,), generator=torch.Generator()
                        .manual_seed(5))
    ends = np.arange(3, 601, 3)
    got = text_llm.embed_words_last4_avg(m, ids, ends, 256, 1024)
    counts = m.expert_counts.clone()
    want = []
    for s in range(0, 768, 256):
        n = min(256, 600 - s)
        buf = torch.zeros(256, dtype=torch.int64, device=card)
        buf[:n] = ids[s:s + n].to(card)
        hs = m(buf, m.positions[:s + 256],
               torch.tensor([n], dtype=torch.int32, device=card))
        want.append(torch.stack([h.float() for h in hs]).mean(0)[:n])
    want = text_llm.word_mean(torch.cat(want), ends).T
    assert _gap(got, want) <= 1e-2
    assert counts.sum(1).tolist() == [600 * 4] * 4
