"""Kimi-Linear's decoder stack (Kimi Linear tech report, arXiv:2510.26692;
``moonshotai/Kimi-Linear-48B-A3B-Instruct``'s ``modeling_kimi.py`` and the
flash-linear-attention kernels it calls) in plain PyTorch, in f32, for the
Kimi text-embedding cell: one full causal forward over a whole document,
with no cache, no chunks and no graphs, then each word's mean over its
tokens of the mean of the last four hidden states (the last normed).  It
imports nothing of the program, and sets TF32 off while it runs.

Per layer: ``h += attn(rms(h)); h += mlp(rms(h))``.  Kimi Delta Attention
(the layers ``linear_attn_config["kda_layers"]``, 1-based), per head
(d = ``head_dim``):

  q, k, v = SiLU(causal depthwise conv_K(W_q x | W_k x | W_v x))
  q ← q / √(‖q‖² + 1e-6) · d^−½,  k ← k / √(‖k‖² + 1e-6)
  g_t = −exp(A_log[h]) · softplus(W_fb W_fa x_t + dt_bias),  β_t = σ(W_b x_t)
  S_t = (I − β_t k_t k_tᵀ) Diag(exp g_t) S_{t−1} + β_t k_t v_tᵀ,  S_0 = 0
  o_t = S_tᵀ q_t;  out = W_o (rms_d(o_t) · w_onorm · σ(W_gb W_ga x_t))

computed as the **token recurrence**, one token after another (decay,
then v' = β(v − Sᵀk), then S += k v'ᵀ), not in chunks.  MLA (the
``full_attn_layers``): DeepSeek-V2's latent attention without a q LoRA
and without rope (``mla_use_nope``): the 64 "rope" dims of q and of the
shared key are used as they come; scale 192^−½.  Layer 0 a dense SwiGLU;
the others a MoE: s = sigmoid(x W_rᵀ) over ``num_experts``, the top k
chosen by s + ``e_score_correction_bias``, weights s[top] / (Σ s[top] +
1e-20) · ``routed_scaling_factor``, the experts held here (``experts_first``
.. ``experts_first + experts_held − 1``) summed over the slots sent to
them, plus one shared SwiGLU.  ``num_expert_group`` is 1: no group step.

The weights come from ``weight(name)`` (``param_spec``'s names, which are
``modeling_kimi.py``'s as far as it could be read) one layer at a time,
upcast to f32 there and dropped after the layer.  ``q`` rounds the
operands of every product (the comparison's control: ``fp8``).

Departures from the published model, each to fit a 32,768-token document
on one card or to hold the program to what it computes:

* everything is f32 (there bf16, with f32 norms, gates, router and
  state);
* attention is computed in blocks of ``block`` queries, each against the
  keys up to its last query (a causal mask inside the block);
* a card holds ``experts_held`` of the routed experts; the experts not
  held add nothing here, as in the program (one card of an
  expert-parallel deployment, without its exchange);
* ``routing`` (optional): a (tokens, k) tensor of expert ids a MoE layer,
  the program's choices, used in place of the reference's own top-k
  (a bf16 program and an f32 reference may choose differently at a
  near-tie); the weights are still the reference's scores of the experts
  used.  ``route_gap`` then says how far from the reference's own choice
  each layer's routing was: the largest, over tokens, of the reference's
  k-th largest choice score (s + bias) less the least of its choice
  scores among the experts used (0 where they agree).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.deepseek_v2 import KV_A_EPS, word_mean

__all__ = ["param_spec", "layer_spec", "kda_layers", "moe_layers",
           "held_experts", "embed_words", "kda_recurrence"]

def kda_layers(m: dict) -> list:
    """The 0-based indices of the KDA layers."""
    return [i - 1 for i in m["linear_attn_config"]["kda_layers"]]


def moe_layers(m: dict) -> list:
    return [i for i in range(m["num_hidden_layers"])
            if m.get("num_experts") and i >= m["first_k_dense_replace"]
            and i % m["moe_layer_freq"] == 0]


def held_experts(m: dict) -> range:
    first = m.get("experts_first", 0)
    return range(first, first + (m.get("experts_held") or m["num_experts"]))


def layer_spec(m: dict, i: int) -> list:
    """``(name, shape, init)`` of layer i's weights; ``init``: "normal"
    (N(0, ``initializer_range``²) bf16), "ones", "bias" (the router's
    selection bias: N(0, ``initializer_range``²) f32), "a_log" (log U[1,
    16] f32), "dt_bias" (softplus⁻¹ of dt log-uniform in [1e-3, 0.1], f32)."""
    H = m["hidden_size"]
    p = f"layers.{i}."
    out = [(p + "input_layernorm.weight", (H,), "ones"),
           (p + "post_attention_layernorm.weight", (H,), "ones")]
    a = p + "self_attn."
    if i in kda_layers(m):
        la = m["linear_attn_config"]
        nh, d, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
        P = nh * d
        out += [(a + f"{x}_proj.weight", (P, H), "normal") for x in "qkv"]
        out += [(a + f"{x}_conv1d.weight", (P, 1, K), "normal") for x in "qkv"]
        out += [(a + "A_log", (1, 1, nh, 1), "a_log"),
                (a + "f_a_proj.weight", (d, H), "normal"),
                (a + "f_b_proj.weight", (P, d), "normal"),
                (a + "dt_bias", (P,), "dt_bias"),
                (a + "b_proj.weight", (nh, H), "normal"),
                (a + "g_a_proj.weight", (d, H), "normal"),
                (a + "g_b_proj.weight", (P, d), "normal"),
                (a + "o_norm.weight", (d,), "ones"),
                (a + "o_proj.weight", (H, P), "normal")]
    else:
        nh = m["num_attention_heads"]
        nope, rope, v = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
        r = m["kv_lora_rank"]
        out += [(a + "q_proj.weight", (nh * (nope + rope), H), "normal"),
                (a + "kv_a_proj_with_mqa.weight", (r + rope, H), "normal"),
                (a + "kv_a_layernorm.weight", (r,), "ones"),
                (a + "kv_b_proj.weight", (nh * (nope + v), r), "normal"),
                (a + "o_proj.weight", (H, nh * v), "normal")]

    def swiglu(q, inter, names=("gate_proj", "up_proj", "down_proj")):
        g, u, dn = names
        return [(q + g + ".weight", (inter, H), "normal"),
                (q + u + ".weight", (inter, H), "normal"),
                (q + dn + ".weight", (H, inter), "normal")]

    if i in moe_layers(m):
        I, E = m["moe_intermediate_size"], m["num_experts"]
        q = p + "block_sparse_moe."
        out += [(q + "gate.weight", (E, H), "normal"),
                (q + "gate.e_score_correction_bias", (E,), "bias")]
        for e in held_experts(m):
            out += swiglu(f"{q}experts.{e}.", I, ("w1", "w3", "w2"))
        if m.get("num_shared_experts"):
            out += swiglu(q + "shared_experts.",
                          I * m["num_shared_experts"])
    else:
        out += swiglu(p + "mlp.", m["intermediate_size"])
    return out


def param_spec(m: dict) -> list:
    """``(name, shape, init)`` of every weight, without ``model.``; no LM
    head."""
    H = m["hidden_size"]
    out = [("embed_tokens.weight", (m["vocab_size"], H), "normal")]
    for i in range(m["num_hidden_layers"]):
        out += layer_spec(m, i)
    return out + [("norm.weight", (H,), "ones")]


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _l2(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + 1e-6)


def kda_recurrence(q, k, v, g, beta, q_round=lambda t: t) -> torch.Tensor:
    """o (n, heads, d) of the gated delta rule from a zero state, one token
    at a time: q, k (normalised), v, g (n, heads, d), beta (n, heads)."""
    n, nh, d = q.shape
    S = torch.zeros(nh, d, d, dtype=q.dtype, device=q.device)
    out = torch.empty(n, nh, 1, d, dtype=q.dtype, device=q.device)
    kS = torch.empty(nh, 1, d, dtype=q.dtype, device=q.device)
    u = torch.empty(nh, d, dtype=q.dtype, device=q.device)
    # a token's views, made once: its decay of each key row (heads, d, 1),
    # k as a row and a column, β·v and −β, q as a row, its output
    a = g.exp()[..., None].unbind(0)
    rows, cols = k[:, :, None, :].unbind(0), k[..., None].unbind(0)
    bv, nb = (beta[..., None] * v).unbind(0), (-beta[..., None]).unbind(0)
    qr, outs = q[:, :, None, :].unbind(0), out.unbind(0)
    for t in range(n):
        S.mul_(a[t])
        torch.bmm(q_round(rows[t]), q_round(S), out=kS)           # Sᵀk
        torch.addcmul(bv[t], kS[:, 0], nb[t], out=u)              # β(v − Sᵀk)
        S.baddbmm_(q_round(cols[t]), q_round(u[:, None, :]))
        torch.bmm(q_round(qr[t]), q_round(S), out=outs[t])        # Sᵀq
    return out[:, :, 0]


def _kda(x, w, a, m, q):
    la = m["linear_attn_config"]
    nh, d, K = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    n = x.shape[0]

    def lin(t, name):
        return q(t) @ q(w[a + name]).T

    proj = torch.cat([lin(x, f"{c}_proj.weight") for c in "qkv"], dim=-1)
    wc = torch.cat([w[a + f"{c}_conv1d.weight"] for c in "qkv"])[:, 0, :]
    xx = F.pad(proj, (0, 0, K - 1, 0))
    conv = xx[0:n] * wc[:, 0]
    for j in range(1, K):
        conv = conv + xx[j:j + n] * wc[:, j]
    qh, kh, vh = F.silu(conv).view(n, 3, nh, d).unbind(1)
    qh, kh = _l2(qh) * d ** -0.5, _l2(kh)
    f = lin(lin(x, "f_a_proj.weight"), "f_b_proj.weight") + w[a + "dt_bias"]
    g = -w[a + "A_log"].view(1, nh, 1).exp() * F.softplus(f).view(n, nh, d)
    beta = torch.sigmoid(lin(x, "b_proj.weight"))
    o = kda_recurrence(qh, kh, vh, g, beta, q)
    gate = lin(lin(x, "g_a_proj.weight"), "g_b_proj.weight").view(n, nh, d)
    o = _rms(o, w[a + "o_norm.weight"], m["rms_norm_eps"]) * torch.sigmoid(gate)
    return lin(o.reshape(n, nh * d), "o_proj.weight")


def _mla(x, w, a, m, q, block):
    n, nh = x.shape[0], m["num_attention_heads"]
    nope, rope, dv = (m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                      m["v_head_dim"])
    r = m["kv_lora_rank"]

    def lin(t, name):
        return q(t) @ q(w[a + name]).T

    Q = lin(x, "q_proj.weight").view(n, nh, nope + rope)
    ckv = lin(x, "kv_a_proj_with_mqa.weight")
    kv = lin(_rms(ckv[:, :r], w[a + "kv_a_layernorm.weight"], KV_A_EPS),
             "kv_b_proj.weight").view(n, nh, nope + dv)
    Kf = torch.cat([kv[..., :nope], ckv[:, None, r:].expand(n, nh, rope)],
                   dim=-1)
    v = kv[..., nope:]
    scale = (nope + rope) ** -0.5
    out = torch.empty(n, nh, dv, dtype=x.dtype, device=x.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        scores = torch.einsum("qhd,khd->hqk", q(Q[s:e]), q(Kf[:e])) * scale
        keys = torch.arange(e, device=x.device)
        queries = torch.arange(s, e, device=x.device)
        scores = scores.masked_fill(keys[None, None] > queries[None, :, None],
                                    -math.inf)
        out[s:e] = torch.einsum("hqk,khd->qhd", q(torch.softmax(scores, -1)),
                                q(v[:e]))
        del scores
    return lin(out.reshape(n, nh * dv), "o_proj.weight")


def _swiglu(x, w, p, q, names=("gate_proj", "up_proj", "down_proj")):
    g, u, d = names

    def lin(a, name):
        return q(a) @ q(w[p + name + ".weight"]).T

    return lin(F.silu(lin(x, g)) * lin(x, u), d)


def _moe(x, w, p, m, routing, q):
    """(output, route_gap, the ids used)."""
    n, k = x.shape[0], m["num_experts_per_token"]
    s = torch.sigmoid(q(x) @ q(w[p + "gate.weight"]).T)
    choice = s + w[p + "gate.e_score_correction_bias"]
    own = torch.topk(choice, k, dim=-1)
    ids = own.indices if routing is None else routing.to(x.device).long()
    gap = float((own.values[:, -1] - choice.gather(1, ids).min(dim=1).values)
                .max()) if n else 0.0
    used = s.gather(1, ids)
    if m.get("moe_renormalize", True):
        used = used / (used.sum(dim=1, keepdim=True) + 1e-20)
    used = used * m["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in held_experts(m):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            rows = _swiglu(x[tok], w, f"{p}experts.{e}.", q, ("w1", "w3", "w2"))
            y.index_add_(0, tok, rows * used[tok, slot, None])
    if m.get("num_shared_experts"):
        y = y + _swiglu(x, w, p + "shared_experts.", q)
    return y, gap, ids


@torch.no_grad()
def embed_words(weight, m: dict, ids: torch.Tensor, word_ends,
                routing=None, q=lambda t: t, block: int = 512) -> tuple:
    """``(E, info)``: E (H, n_words) f32, the words' last-four means;
    ``info``: ``route_gap`` (the largest over MoE layers) and ``routes``
    (the ids each MoE layer used, (n, k) each).  ``weight(name)`` gives a
    weight (any dtype; used in f32); ``routing``: one (n, k) tensor a MoE
    layer, or None."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _embed(weight, m, ids, word_ends, routing, q, block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _embed(weight, m, ids, word_ends, routing, q, block):
    L, eps = m["num_hidden_layers"], m["rms_norm_eps"]
    h = weight("embed_tokens.weight")[ids].float()
    kda, moe = kda_layers(m), moe_layers(m)
    last, gaps, routes = [], [], []
    for i in range(L):
        p = f"layers.{i}."
        w = {name: weight(name).float() for name, _, _ in layer_spec(m, i)}
        x = _rms(h, w[p + "input_layernorm.weight"], eps)
        a = (_kda(x, w, p + "self_attn.", m, q) if i in kda
             else _mla(x, w, p + "self_attn.", m, q, block))
        h = h + a
        x = _rms(h, w[p + "post_attention_layernorm.weight"], eps)
        if i in moe:
            j = moe.index(i)
            y, gap, used = _moe(x, w, p + "block_sparse_moe.", m,
                                None if routing is None else routing[j], q)
            gaps.append(gap)
            routes.append(used)
        else:
            y = _swiglu(x, w, p + "mlp.", q)
        h = h + y
        del w, x, a, y
        if L - 4 <= i < L - 1:
            last.append(h)
    last.append(_rms(h, weight("norm.weight").float(), eps))
    tokens = torch.stack(last[-4:]).mean(dim=0)
    return (word_mean(tokens, word_ends).T,
            {"route_gap": max(gaps) if gaps else 0.0, "routes": routes})
