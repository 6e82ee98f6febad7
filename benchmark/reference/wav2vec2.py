"""wav2vec2-large-xlsr-53's speech embedding, the plain reference of the
``wav2vec2_xlsr53`` cells: the mean of the last four hidden states of the
model over a long waveform, embedded in overlapping fixed-size chunks.

Written from the published architecture (Baevski et al., arXiv:2006.11477;
Conneau et al., arXiv:2006.13979; the checkpoint's ``config.json`` at
huggingface.co/facebook/wav2vec2-large-xlsr-53: ``do_stable_layer_norm``,
``feat_extract_norm: layer``), in plain PyTorch at f32 with TF32 off
(``precision`` of ``reference/train.py``; its ``tf32`` is the control).
It imports neither JAX nor anything of the program, and takes nothing the
program has made: the weights are the dict the benchmark draws, under the
checkpoint's parameter names.

One chunk, a waveform (1, T) and a sample mask (1, T):

* the conv stack: 7 convolutions without bias (kernels (10, 3, 3, 3, 3, 2,
  2), strides (5, 2, 2, 2, 2, 2, 2), 512 channels), each followed by a
  LayerNorm over the channels and the exact GELU 0.5·x·(1 + erf(x/√2));
* the feature projection: LayerNorm over 512, then 512 → H;
* padded frames (those at or past the conv output length of the valid
  samples) set to 0;
* the positional embedding: a grouped convolution (K = 128, 16 groups,
  K // 2 padding on both sides) whose kernel is ``weight_g · weight_v /
  ‖weight_v‖``, one norm per kernel tap over the output and input axes;
  its last frame dropped (K is even), GELU, added to the frames;
* 24 pre-LN layers: LayerNorm → attention (16 heads; queries scaled by
  1/√d; padded keys' scores plus ``finfo(f32).min``; softmax over keys)
  → residual, LayerNorm → H → 4096 → H with GELU → residual;
* the hidden states: the input of every layer, then the last layer's
  output after the final LayerNorm (only that last one is normalised);
  the embedding is the mean of the last four.

The chunk plan: chunks of ``chunk_sec`` (cut to a multiple of the conv
stack's stride, 320 samples) that start on that stride, ``overlap_sec``
of frames (one at least) shared by neighbours; a waveform of one chunk
or less is one forward at its own length, unmasked.  Otherwise the last
chunk is zero-padded to the chunk size and masked.  Global frame f comes
from the chunk that holds it at least ``overlap`` frames from either edge
(the first chunk from its start, the last to its end): so every frame of
the result is an interior frame of the chunk it comes from.

Departures from the published model: weights are random (drawn by the
benchmark as ``init_random`` draws them: He-normal conv kernels, N(0,
0.02²) dense kernels, zero biases, unit LayerNorms, ``weight_g`` the
per-tap norm of ``weight_v``); no dropout, LayerDrop or SpecAugment
(inference), so ``masked_spec_embed`` is unused; the last-four mean and
the chunking are the benchmark's embedding, not part of the model.
"""

from __future__ import annotations

import math

import torch

__all__ = ["param_spec", "num_frames", "chunk_plan", "chunk_embedding",
           "embed"]


def param_spec(m: dict) -> list:
    """``(name, shape, init)`` of every weight, in the checkpoint's names;
    ``init`` is ``("he",)``, ``("normal", std)``, ``("zeros",)``,
    ``("ones",)``, ``("uniform", lo, hi)`` or ``("tap_norm", of)``."""
    H, F = m["hidden_size"], m["intermediate_size"]
    G, K = m["num_conv_pos_embedding_groups"], m["num_conv_pos_embeddings"]
    std = ("normal", m.get("initializer_range", 0.02))
    out = [("masked_spec_embed", (H,), ("uniform", 0.0, 0.01))]

    def norm(prefix, width):
        out.append((prefix + ".weight", (width,), ("ones",)))
        out.append((prefix + ".bias", (width,), ("zeros",)))

    def dense(prefix, n_out, n_in):
        out.append((prefix + ".weight", (n_out, n_in), std))
        out.append((prefix + ".bias", (n_out,), ("zeros",)))

    c_in = 1
    for i, (c, k) in enumerate(zip(m["conv_dim"], m["conv_kernel"])):
        p = f"feature_extractor.conv_layers.{i}"
        out.append((p + ".conv.weight", (c, c_in, k), ("he",)))
        if m.get("conv_bias", False):
            out.append((p + ".conv.bias", (c,), ("zeros",)))
        norm(p + ".layer_norm", c)
        c_in = c
    norm("feature_projection.layer_norm", c_in)
    dense("feature_projection.projection", H, c_in)
    p = "encoder.pos_conv_embed.conv"
    out.append((p + ".weight_v", (H, H // G, K), ("he",)))
    out.append((p + ".weight_g", (1, 1, K), ("tap_norm", p + ".weight_v")))
    out.append((p + ".bias", (H,), ("zeros",)))
    norm("encoder.layer_norm", H)
    for i in range(m["num_hidden_layers"]):
        p = f"encoder.layers.{i}"
        norm(p + ".layer_norm", H)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.attention.{proj}", H, H)
        norm(p + ".final_layer_norm", H)
        dense(p + ".feed_forward.intermediate_dense", F, H)
        dense(p + ".feed_forward.output_dense", H, F)
    return out


def num_frames(m: dict, n_samples: int) -> int:
    """The conv stack's output length for ``n_samples`` samples."""
    n = n_samples
    for k, s in zip(m["conv_kernel"], m["conv_stride"]):
        n = (n - k) // s + 1
    return n


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _layer_norm(x, w: dict, prefix: str, eps: float):
    """Over the last axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[prefix + ".weight"] \
        + w[prefix + ".bias"]


def _dense(x, w: dict, prefix: str):
    return x @ w[prefix + ".weight"].T + w[prefix + ".bias"]


def chunk_embedding(w: dict, m: dict, wav, mask=None):
    """The mean of the last four hidden states of one waveform (T,) with an
    optional sample mask (T,) bool → (T', H)."""
    eps = m["layer_norm_eps"]
    x = wav[None, None, :]
    for i, s in enumerate(m["conv_stride"]):
        p = f"feature_extractor.conv_layers.{i}"
        x = torch.nn.functional.conv1d(x, w[p + ".conv.weight"],
                                       w.get(p + ".conv.bias"), stride=s)
        x = _gelu(_layer_norm(x.transpose(1, 2), w, p + ".layer_norm",
                              eps).transpose(1, 2))
    h = x[0].T                                       # (T', 512)
    h = _dense(_layer_norm(h, w, "feature_projection.layer_norm", eps), w,
               "feature_projection.projection")      # (T', H)
    T = h.shape[0]
    bias = None
    if mask is not None:
        valid = num_frames(m, int(mask.sum()))
        keep = torch.arange(T, device=h.device) < valid
        h = torch.where(keep[:, None], h, torch.zeros_like(h))
        bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
    p = "encoder.pos_conv_embed.conv"
    v, g = w[p + ".weight_v"], w[p + ".weight_g"]
    kernel = g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    K = kernel.shape[-1]
    pos = torch.nn.functional.conv1d(
        h.T[None], kernel, w[p + ".bias"], padding=K // 2,
        groups=m["num_conv_pos_embedding_groups"])[0]
    if K % 2 == 0:
        pos = pos[:, :-1]
    h = h + _gelu(pos).T
    heads = m["num_attention_heads"]
    d = h.shape[1] // heads
    states = []
    L = m["num_hidden_layers"]
    for i in range(L):
        if i >= L - 3:
            states.append(h)
        p = f"encoder.layers.{i}"
        a = _layer_norm(h, w, p + ".layer_norm", eps)
        q, k, vv = (_dense(a, w, f"{p}.attention.{n}_proj").view(T, heads, d)
                    .transpose(0, 1) for n in ("q", "k", "v"))
        scores = (q / math.sqrt(d)) @ k.transpose(1, 2)   # (heads, T, T)
        if bias is not None:
            scores = scores + bias
        att = torch.softmax(scores, dim=-1) @ vv          # (heads, T, d)
        h = h + _dense(att.transpose(0, 1).reshape(T, -1), w,
                       p + ".attention.out_proj")
        f = _layer_norm(h, w, p + ".final_layer_norm", eps)
        f = _gelu(_dense(f, w, p + ".feed_forward.intermediate_dense"))
        h = h + _dense(f, w, p + ".feed_forward.output_dense")
    states.append(_layer_norm(h, w, "encoder.layer_norm", eps))
    return torch.stack(states[-4:]).mean(dim=0)


def chunk_plan(m: dict, n_samples: int, chunk_sec: float,
               overlap_sec: float, sample_rate: int) -> list:
    """``(start, first, stop)`` of each chunk: its first sample, and the
    global frames [first, stop) the result takes from it (module
    docstring).  One entry ``(0, 0, frames)`` for a waveform of one chunk
    or less, run at its own length."""
    stride = math.prod(m["conv_stride"])
    chunk = int(chunk_sec * sample_rate) // stride * stride
    total = num_frames(m, n_samples)
    if n_samples <= chunk:
        return [(0, 0, total)]
    ov = max(int(round(overlap_sec * sample_rate / stride)), 1)
    per_chunk = num_frames(m, chunk)
    step = per_chunk - 2 * ov           # frames between two chunks' starts
    if step <= 0:
        raise ValueError("the overlap leaves no interior")
    starts = [0]
    while starts[-1] * stride + chunk < n_samples:
        starts.append(starts[-1] + step)
    plan = []
    for i, g0 in enumerate(starts):
        first = 0 if i == 0 else g0 + ov
        stop = total if i == len(starts) - 1 else g0 + per_chunk - ov
        plan.append((g0 * stride, first, stop))
    return plan


@torch.no_grad()
def embed(w: dict, m: dict, waveform, chunk_sec: float, overlap_sec: float,
          sample_rate: int):
    """The last-four mean over the whole waveform (T,) → (H, T'), each
    chunk's frames written where the plan puts them."""
    wav = waveform.reshape(-1).float()
    n = wav.shape[0]
    plan = chunk_plan(m, n, chunk_sec, overlap_sec, sample_rate)
    if len(plan) == 1:
        return chunk_embedding(w, m, wav).T
    stride = math.prod(m["conv_stride"])
    chunk = int(chunk_sec * sample_rate) // stride * stride
    out = torch.empty(num_frames(m, n), m["hidden_size"], device=wav.device)
    for start, first, stop in plan:
        piece = torch.zeros(chunk, device=wav.device)
        valid = min(chunk, n - start)
        piece[:valid] = wav[start:start + valid]
        mask = torch.arange(chunk, device=wav.device) < valid
        e = chunk_embedding(w, m, piece, mask)
        g0 = start // stride
        out[first:stop] = e[first - g0:stop - g0]
    return out.T
