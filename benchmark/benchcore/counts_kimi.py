"""The yardstick's arithmetic for Kimi-Linear's text embedding, from the
configuration's keys alone (``modeling_kimi.py``'s names): the model FLOPs
of a document (the experts held here only), and the least time of the KDA
kernel (``csrc/kda.cu``) a chunk.  2 operations a multiply-add; norms,
gates, convolutions, softmaxes and SiLU not counted.

The KDA kernel's count is a fixed formula of the chunked form over
sub-chunks of ``SUB`` = 64 tokens, the same whatever implements it: for a
sub-chunk and a head (d the head size), the multiply-adds of A and Aqk
(64²·d each), the triangular solve (64³/6), W and U′ = T(β ⊙ v) (64²·d
each), W·S₀, (q ⊙ e^G)·S₀ and the state's update (64·d² each) and Aqk·U
(64²·d).  Its bytes: q, k, v and o in bf16, g in f32 and β in f32 a token
and head, the f32 state read and written once a chunk.
"""

from __future__ import annotations

from benchcore.counts import PEAKS
from reference.kimi_linear import held_experts, kda_layers, moe_layers

__all__ = ["SUB", "kda_sub_flops", "kda_chunk_flops", "kda_chunk_bytes",
           "kda_bound_s", "token_flops", "attention_flops", "doc_flops"]

SUB = 64


def _la(m: dict) -> tuple:
    la = m["linear_attn_config"]
    return la["num_heads"], la["head_dim"]


def kda_sub_flops(d: int, sub: int = SUB) -> float:
    """A full sub-chunk of one head in the chunk-64 form (module
    docstring)."""
    macs = 5 * sub * sub * d + sub ** 3 / 6 + 3 * sub * d * d
    return 2.0 * macs


def kda_chunk_flops(m: dict, tokens: int) -> float:
    """One KDA layer's kernel over a chunk of ``tokens`` (every row,
    padding too: the kernel computes it), its sub-chunks rounded up."""
    nh, d = _la(m)
    return nh * -(-tokens // SUB) * kda_sub_flops(d)


def kda_chunk_bytes(m: dict, tokens: int) -> float:
    """One KDA layer's kernel over a chunk: q, k, v, o bf16, g and β f32,
    the f32 state in and out."""
    nh, d = _la(m)
    return tokens * nh * (4 * d * 2 + d * 4 + 4) + 2 * nh * d * d * 4


def kda_bound_s(m: dict, tokens: int) -> float:
    """The least time of one KDA layer's kernel a chunk: the larger of its
    operations at the bf16 peak and its bytes at 3.35 TB/s."""
    return max(kda_chunk_flops(m, tokens) / PEAKS["bfloat16"],
               kda_chunk_bytes(m, tokens) / PEAKS["hbm_bytes_per_s"])


def _kda_layer_flops(m: dict) -> float:
    """A token's KDA layer outside the kernel: the q, k, v, o projections,
    the gates' two low-rank pairs and β's projection."""
    H = m["hidden_size"]
    nh, d = _la(m)
    P = nh * d
    return 2.0 * (3 * H * P + P * H + 2 * (H * d + d * P) + H * nh)


def _mla_flops(m: dict) -> float:
    """A token's MLA projections a layer: q, kv_a, kv_b (once a token),
    o."""
    H, nh = m["hidden_size"], m["num_attention_heads"]
    qd = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    r, rope = m["kv_lora_rank"], m["qk_rope_head_dim"]
    kv = m["qk_nope_head_dim"] + m["v_head_dim"]
    return 2.0 * (H * nh * qd + H * (r + rope) + r * nh * kv
                  + nh * m["v_head_dim"] * H)


def token_flops(m: dict) -> float:
    """A token's operations outside attention's core, every layer, with
    the KDA kernel's per-token share (a sub-chunk's over 64) and the
    routed experts' rows of the experts held here (k · held / E a token,
    the routing's expectation)."""
    H, I, E = (m["hidden_size"], m["moe_intermediate_size"],
               m["num_experts"])
    L = m["num_hidden_layers"]
    n_kda, n_moe = len(kda_layers(m)), len(moe_layers(m))
    nh, d = _la(m)
    kda = _kda_layer_flops(m) + nh * kda_sub_flops(d) / SUB
    rows = m["num_experts_per_token"] * len(held_experts(m)) / E
    moe = (2.0 * H * E + rows * 2.0 * 3 * H * I
           + 2.0 * 3 * H * I * m.get("num_shared_experts", 0))
    dense = 2.0 * 3 * H * m["intermediate_size"]
    return (n_kda * kda + (L - n_kda) * _mla_flops(m) + n_moe * moe
            + (L - n_moe) * dense)


def attention_flops(m: dict, n: int) -> float:
    """The MLA layers' causal attention core over n tokens: 2·heads·(192 +
    128) a (query, key) pair a layer, n(n + 1)/2 pairs."""
    per_pair = 2.0 * m["num_attention_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"])
    n_mla = m["num_hidden_layers"] - len(kda_layers(m))
    return n_mla * per_pair * n * (n + 1) / 2


def doc_flops(m: dict, n: int) -> float:
    """The model FLOPs of one document of n tokens (its real tokens only)."""
    return n * token_flops(m) + attention_flops(m, n)
