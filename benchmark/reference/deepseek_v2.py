"""DeepSeek-V2's decoder stack (arXiv:2405.04434; transformers'
``DeepseekV2Model`` as the model's own ``modeling_deepseek.py`` writes it)
in plain PyTorch, in f32, for the text-embedding cells: one full causal
forward over a whole document, with no cache, no chunks and no graphs,
then each word's mean over its tokens of the mean of the last four hidden
states (``output_hidden_states[-4:]``, the last normed).  It imports
nothing of the program.

The weights come from ``weight(name)`` (transformers' names, bf16, as
``param_spec`` lists them) one layer at a time, upcast to f32 there and
dropped after the layer, so the reference holds one layer in f32 beside
its activations.  ``precision`` (``reference/train.py``) sets the
arithmetic of every product (``float32``, TF32 off; ``fp8``: operands
rounded to e4m3 with one scale a tensor, the comparison's control).

Departures from ``modeling_deepseek.py``, each to fit 16,384 tokens or to
compare with a program that rounds otherwise:

* everything is f32 (there bf16, with f32 norms, softmaxes and router);
  rope's cos/sin stay f32 (there cast to the activations' bf16);
* attention is computed in blocks of ``block`` queries, each against the
  keys up to its last query (a causal mask inside the block); the same
  sums as one softmax over the row;
* the routed experts run one expert at a time over its tokens, and each
  token's slots are summed in slot order;
* ``routing`` (optional): a (tokens, k) tensor of expert ids a MoE layer,
  the program's choices, used in place of the reference's own greedy
  top-k (a bf16 program and an f32 reference may choose differently at a
  near-tie); the weights are still the reference's probabilities of the
  experts used.  ``route_gap`` then says how far from the reference's own
  choice each layer's routing was: the largest, over tokens, of the
  reference's k-th largest probability less the least of its
  probabilities among the experts used (0 where they agree).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["param_spec", "moe_layers", "inv_freq", "softmax_scale",
           "embed_words", "word_mean"]

KV_A_EPS = 1e-6  # kv_a_layernorm's eps: DeepseekV2RMSNorm's default


def moe_layers(m: dict) -> list:
    """The indices of the MoE layers (``first_k_dense_replace`` on, every
    ``moe_layer_freq``-th)."""
    return [i for i in range(m["num_hidden_layers"])
            if m.get("n_routed_experts") and i >= m["first_k_dense_replace"]
            and i % m["moe_layer_freq"] == 0]


def _layer_spec(m: dict, i: int) -> list:
    H, nh = m["hidden_size"], m["num_attention_heads"]
    nope, rope, v = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                     m["v_head_dim"])
    r = m["kv_lora_rank"]
    p = f"layers.{i}."
    out = [(p + "input_layernorm.weight", (H,), "ones"),
           (p + "post_attention_layernorm.weight", (H,), "ones"),
           (p + "self_attn.q_proj.weight", (nh * (nope + rope), H), "normal"),
           (p + "self_attn.kv_a_proj_with_mqa.weight", (r + rope, H),
            "normal"),
           (p + "self_attn.kv_a_layernorm.weight", (r,), "ones"),
           (p + "self_attn.kv_b_proj.weight", (nh * (nope + v), r), "normal"),
           (p + "self_attn.o_proj.weight", (H, nh * v), "normal")]

    def swiglu(q, inter):
        return [(q + "gate_proj.weight", (inter, H), "normal"),
                (q + "up_proj.weight", (inter, H), "normal"),
                (q + "down_proj.weight", (H, inter), "normal")]

    if i in moe_layers(m):
        I = m["moe_intermediate_size"]
        out.append((p + "mlp.gate.weight", (m["n_routed_experts"], H),
                    "normal"))
        for e in range(m["n_routed_experts"]):
            out += swiglu(f"{p}mlp.experts.{e}.", I)
        if m.get("n_shared_experts"):
            out += swiglu(p + "mlp.shared_experts.",
                          I * m["n_shared_experts"])
    else:
        out += swiglu(p + "mlp.", m["intermediate_size"])
    return out


def param_spec(m: dict) -> list:
    """``(name, shape, init)`` of every weight (``init``: "normal" for
    N(0, ``initializer_range``²), "ones"), transformers' names without
    ``model.``; no LM head."""
    H = m["hidden_size"]
    out = [("embed_tokens.weight", (m["vocab_size"], H), "normal")]
    for i in range(m["num_hidden_layers"]):
        out += _layer_spec(m, i)
    return out + [("norm.weight", (H,), "ones")]


def _mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(m: dict) -> torch.Tensor:
    """YaRN's ``inv_freq`` (DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache),
    f32 on the CPU; the plain rope's without ``rope_scaling``."""
    dim, base = m["qk_rope_head_dim"], float(m["rope_theta"])
    ar = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** ar)
    rs = m.get("rope_scaling")
    if not rs:
        return extra
    factor, orig = rs["factor"], rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * base ** ar)

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) \
            / (2 * math.log(base))

    low = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def _cos_sin_scale(m: dict) -> float:
    rs = m.get("rope_scaling")
    if not rs:
        return 1.0
    return (_mscale(rs["factor"], rs.get("mscale", 1))
            / _mscale(rs["factor"], rs.get("mscale_all_dim", 0)))


def softmax_scale(m: dict) -> float:
    s = (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) ** -0.5
    rs = m.get("rope_scaling")
    if rs and rs.get("mscale_all_dim", 0):
        s *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope(x, cos, sin):
    """apply_rotary_pos_emb: pairs (2i, 2i + 1) moved to (i, i + d/2), then
    x·cos + rotate_half(x)·sin, cos/sin (n, d) as cat(freqs, freqs)."""
    d = x.shape[-1]
    x = x.reshape(*x.shape[:-1], d // 2, 2).transpose(-1, -2) \
        .reshape(*x.shape[:-1], d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def _attention(x, w, p, m, cos, sin, q, block):
    n, nh = x.shape[0], m["num_attention_heads"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r = m["kv_lora_rank"]

    def lin(a, name):
        return q(a) @ q(w[p + name]).T

    qh = lin(x, "q_proj.weight").view(n, nh, nope + rope)
    ckv = lin(x, "kv_a_proj_with_mqa.weight")
    c, k_pe = ckv[:, :r], ckv[:, r:]
    kv = lin(_rms(c, w[p + "kv_a_layernorm.weight"], KV_A_EPS),
             "kv_b_proj.weight").view(n, nh, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = _rope(qh[..., nope:], cos[:, None], sin[:, None])
    k_pe = _rope(k_pe, cos, sin)
    Q = torch.cat([qh[..., :nope], q_pe], dim=-1)
    K = torch.cat([k_nope, k_pe[:, None].expand(n, nh, rope)], dim=-1)
    scale = softmax_scale(m)
    out = torch.empty(n, nh, dv, dtype=x.dtype, device=x.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        scores = torch.einsum("qhd,khd->hqk", q(Q[s:e]), q(K[:e])) * scale
        keys = torch.arange(e, device=x.device)
        queries = torch.arange(s, e, device=x.device)
        scores = scores.masked_fill(keys[None, None] > queries[None, :, None],
                                    -math.inf)
        out[s:e] = torch.einsum("hqk,khd->qhd", q(torch.softmax(scores, -1)),
                                q(v[:e]))
    return lin(out.reshape(n, nh * dv), "o_proj.weight")


def _swiglu(x, w, p, q):
    def lin(a, name):
        return q(a) @ q(w[p + name]).T

    return lin(F.silu(lin(x, "gate_proj.weight")) * lin(x, "up_proj.weight"),
               "down_proj.weight")


def _moe(x, w, p, m, routing, q):
    """(output, route_gap, the ids used)."""
    n, k, E = x.shape[0], m["num_experts_per_tok"], m["n_routed_experts"]
    probs = torch.softmax(q(x) @ q(w[p + "gate.weight"]).T, dim=-1)
    own = torch.topk(probs, k, dim=-1)
    ids = own.indices if routing is None else routing.to(x.device).long()
    used = probs.gather(1, ids)
    gap = float((own.values[:, -1] - used.min(dim=1).values).max()) \
        if n else 0.0
    rows = torch.zeros(n, k, x.shape[1], dtype=x.dtype, device=x.device)
    for e in range(E):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            rows[tok, slot] = _swiglu(x[tok], w, f"{p}experts.{e}.", q)
    y = torch.zeros_like(x)
    for s in range(k):
        y = y + rows[:, s] * used[:, s, None]
    if m.get("n_shared_experts"):
        y = y + _swiglu(x, w, p + "shared_experts.", q)
    return y, gap, ids


def word_mean(tokens: torch.Tensor, word_ends) -> torch.Tensor:
    """(n_words, H) f32: each word's mean over its tokens, by differences
    of an f64 running sum."""
    ends = torch.as_tensor(word_ends, dtype=torch.int64, device=tokens.device)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    c = torch.cat([tokens.new_zeros(1, tokens.shape[1], dtype=torch.float64),
                   tokens.double().cumsum(0)])
    return ((c[ends] - c[starts]) / (ends - starts)[:, None]).float()


@torch.no_grad()
def embed_words(weight, m: dict, ids: torch.Tensor, word_ends,
                routing=None, q=lambda t: t, block: int = 1024) -> tuple:
    """``(E, info)``: E (H, n_words) f32, the words' last-four means;
    ``info``: ``route_gap`` (the largest over MoE layers) and ``routes``
    (the ids each MoE layer used, (n, k) each).  ``weight(name)`` gives a
    weight (any dtype; used in f32); ``routing``: one (n, k) tensor a MoE
    layer, or None."""
    dev = ids.device
    n, L = ids.shape[0], m["num_hidden_layers"]
    freqs = torch.arange(n, dtype=torch.float32, device=dev)[:, None] \
        * inv_freq(m).to(dev)[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = emb.cos() * _cos_sin_scale(m)
    sin = emb.sin() * _cos_sin_scale(m)
    h = weight("embed_tokens.weight")[ids].float()
    moe = moe_layers(m)
    eps = m["rms_norm_eps"]
    last, gaps, routes = [], [], []
    for i in range(L):
        p = f"layers.{i}."
        w = {name: weight(name).float() for name, _, _ in _layer_spec(m, i)}
        a = _attention(_rms(h, w[p + "input_layernorm.weight"], eps), w,
                       p + "self_attn.", m, cos, sin, q, block)
        h = h + a
        x = _rms(h, w[p + "post_attention_layernorm.weight"], eps)
        if i in moe:
            j = moe.index(i)
            y, gap, used = _moe(x, w, p + "mlp.", m,
                                None if routing is None else routing[j], q)
            gaps.append(gap)
            routes.append(used)
        else:
            y = _swiglu(x, w, p + "mlp.", q)
        h = h + y
        del w
        if L - 4 <= i < L - 1:
            last.append(h)
    last.append(_rms(h, weight("norm.weight").float(), eps))
    tokens = torch.stack(last[-4:]).mean(dim=0)
    return (word_mean(tokens, word_ends).T,
            {"route_gap": max(gaps) if gaps else 0.0, "routes": routes})
