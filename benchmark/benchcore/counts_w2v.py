"""The model FLOPs of wav2vec2's forward, from shapes: a frozen copy of
``chip_smoke.py:w2v_flops`` over the configuration's keys (2 operations a
multiply-add; the conv stack, the projection, the positional conv and the
encoder layers with attention over every frame; LayerNorms, GELUs and the
softmax not counted)."""

from __future__ import annotations

__all__ = ["w2v_flops"]


def w2v_flops(m: dict, n_samples: int, layers: bool = True) -> float:
    """Operations of one forward over ``n_samples`` samples (``m``: the
    configuration's ``model`` section, transformers' key names)."""
    flops, n, c_in = 0.0, n_samples, 1
    for c_out, k, s in zip(m["conv_dim"], m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
        flops += 2.0 * n * c_out * c_in * k
        c_in = c_out
    if not layers:
        return flops
    H, T = m["hidden_size"], n
    flops += 2.0 * T * c_in * H
    flops += 2.0 * T * H * (H // m["num_conv_pos_embedding_groups"]) \
        * m["num_conv_pos_embeddings"]
    per_layer = 2.0 * T * (4 * H * H + 2 * H * m["intermediate_size"]) \
        + 4.0 * T * T * H
    return flops + m["num_hidden_layers"] * per_layer
