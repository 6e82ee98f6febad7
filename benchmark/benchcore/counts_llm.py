"""The yardstick's arithmetic for DeepSeek-V2's text embedding, from the
configuration's keys alone (transformers' names): the model FLOPs of a
document, and the least time the card could take for the MoE's grouped
GEMMs and its route and combine kernels a chunk.  2 operations a
multiply-add; norms, rope, softmaxes and SiLU not counted."""

from __future__ import annotations

from benchcore.counts import PEAKS
from reference.deepseek_v2 import moe_layers

__all__ = ["moe_layer_count", "token_flops", "attention_flops", "doc_flops",
           "experts_gemm_bound_s", "moe_kernels_bound_s"]


def moe_layer_count(m: dict) -> int:
    return len(moe_layers(m))


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
    """A token's operations outside attention's core, every layer (4.48
    GFLOP at DeepSeek-V2-Lite's widths)."""
    H, I = m["hidden_size"], m["moe_intermediate_size"]
    n_moe = moe_layer_count(m)
    dense = 2.0 * 3 * H * m["intermediate_size"]
    moe = (2.0 * H * m["n_routed_experts"]
           + m["num_experts_per_tok"] * 2.0 * 3 * H * I
           + 2.0 * 3 * H * I * m["n_shared_experts"])
    return (m["num_hidden_layers"] * _mla_flops(m)
            + (m["num_hidden_layers"] - n_moe) * dense + n_moe * moe)


def attention_flops(m: dict, n: int) -> float:
    """Causal attention's core over n tokens: 2·heads·(192 + 128) a
    (query, key) pair a layer, n(n + 1)/2 pairs."""
    per_pair = 2.0 * m["num_attention_heads"] * (
        m["qk_nope_head_dim"] + m["qk_rope_head_dim"] + m["v_head_dim"])
    return m["num_hidden_layers"] * per_pair * n * (n + 1) / 2


def doc_flops(m: dict, n: int) -> float:
    """The model FLOPs of one document of n tokens (its real tokens only:
    not the chunk's padding, nor the prefix's re-expansion each chunk)."""
    return n * token_flops(m) + attention_flops(m, n)


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAKS["bfloat16"], nbytes / PEAKS["hbm_bytes_per_s"])


def experts_gemm_bound_s(m: dict, tokens: int) -> float:
    """The least time of one MoE layer's two grouped GEMMs over a chunk of
    ``tokens`` (every row, padding too: the GEMMs compute it), each the
    larger of its operations at the bf16 peak and its bytes at 3.35 TB/s:
    every expert's weights read once, its rows in and out once (bf16)."""
    H, I = m["hidden_size"], m["moe_intermediate_size"]
    E = m["n_routed_experts"]
    rows = tokens * m["num_experts_per_tok"]
    gate_up = _bound(2.0 * rows * H * 2 * I,
                     2.0 * (E * 2 * I * H + rows * H + rows * 2 * I))
    down = _bound(2.0 * rows * I * H, 2.0 * (E * H * I + rows * I + rows * H))
    return gate_up + down


def moe_kernels_bound_s(m: dict, tokens: int) -> float:
    """The least time of one MoE layer's route (two kernels) and combine
    over a chunk: bytes at 3.35 TB/s.  Route reads the f32 logits and
    writes the ids, weights, rows, tokens of rows and offsets; combine
    reads each token's k expert rows, its shared row and its ids and
    weights, and writes its output row (bf16 rows)."""
    H, E, k = m["hidden_size"], m["n_routed_experts"], m["num_experts_per_tok"]
    route = 4.0 * (tokens * E + tokens * k * 4 + E)
    combine = 2.0 * (tokens * k * H + 2 * tokens * H) + 8.0 * tokens * k
    return (route + combine) / PEAKS["hbm_bytes_per_s"]
