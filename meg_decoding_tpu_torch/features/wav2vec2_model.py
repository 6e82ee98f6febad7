"""wav2vec2 (stable layer norm, layer-normed conv stack) as a torch module.

The JAX package runs transformers' Flax ``FlaxWav2Vec2Model``
(``meg_decoding_tpu/features/wav2vec.py:load_wav2vec``) with the
wav2vec2-large-xlsr-53 architecture: ``do_stable_layer_norm=True``,
``feat_extract_norm="layer"``.  This is that network, written for the
port, with the Flax module tree and parameter names (``interop.py`` maps
Flax and transformers-torch weights onto it):

* ``feature_extractor.conv_layers.{i}`` — ``conv`` (Conv1d, no padding),
  ``layer_norm`` over the channels, exact erf GELU; 7 layers of 512
  channels, kernels (10, 3, 3, 3, 3, 2, 2), strides (5, 2, 2, 2, 2, 2, 2);
* ``feature_projection`` — ``layer_norm``, then ``projection`` 512 → H;
* ``encoder.pos_conv_embed.conv`` — grouped conv (K = 128, 16 groups),
  weight-normalised per kernel tap (``weight_v`` (H, H/16, K),
  ``weight_g`` (1, 1, K), the norm over the first two axes: torch's
  ``weight_norm(dim=2)``), padded K//2 on both sides, the last frame
  dropped when K is even, then GELU;
* ``encoder.layers.{i}`` — pre-LN blocks: ``layer_norm`` → ``attention``
  (``q_proj``/``k_proj``/``v_proj``/``out_proj``) → residual,
  ``final_layer_norm`` → ``feed_forward`` (``intermediate_dense``, GELU,
  ``output_dense``) → residual;
* ``encoder.layer_norm`` — the final LayerNorm.

``hidden_states`` follow Flax (``FlaxWav2Vec2StableLayerNormEncoder``): the
input of every layer, then the last layer's output after the final
LayerNorm; only that last entry is normalised.

Masks (a sample mask ``attention_mask`` (B, T)): the conv stack sees the
zero-padded waveform unmasked; the mask becomes a frame mask through the
conv output lengths; padded frames are set to 0 before the positional
conv, and padded keys get ``finfo(f32).min`` in every attention.

Scopes of a captured forward (``utils/profiling.py``; ``features/
wav2vec.py`` graphs the chunk forward): ``w2v_conv`` the conv stack and
the feature projection, ``w2v_pos_conv`` the positional conv (its
weight-norm kernel and the grouped conv), ``attention`` the q/k/v/out
projections, scores, mask bias and softmax, ``ffn`` the feed-forward
block; every GELU is in ``gelu`` (``ops/gelu.py``), the innermost.  The
encoder's LayerNorms and residual adds are outside every scope.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from meg_decoding_tpu_torch.ops.gelu import gelu
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = ["Wav2Vec2Config", "Wav2Vec2Model", "XLSR53"]


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


# transformers' names: wav2vec2's exact erf GELU (``ops/gelu.py``'s
# ``erf``, in its scope), CLIP's quick GELU
ACTIVATIONS = {
    "gelu": lambda x: gelu(x, "erf"),
    "quick_gelu": _quick_gelu,
}


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The architecture's hyper-parameters, with transformers' key names.
    The defaults are the configuration ``load_wav2vec`` builds for its
    random backend (``meg_decoding_tpu/features/wav2vec.py:57-61``):
    wav2vec2-large-xlsr-53's widths, transformers' defaults elsewhere."""

    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "gelu"
    feat_extract_activation: str = "gelu"
    conv_dim: tuple = (512,) * 7
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    do_stable_layer_norm: bool = True
    feat_extract_norm: str = "layer"
    add_adapter: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Wav2Vec2Config":
        """From a transformers ``config.json`` (unknown keys ignored);
        raises for an architecture this module does not implement."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in d.items() if k in names}
        cfg = cls(**kw)
        if not cfg.do_stable_layer_norm or cfg.feat_extract_norm != "layer":
            raise NotImplementedError(
                "only the stable-layer-norm wav2vec2 with feat_extract_norm="
                "'layer' is implemented (as in the Flax model the JAX "
                "package runs)")
        if cfg.add_adapter:
            raise NotImplementedError("wav2vec2 adapters are not implemented")
        for act in (cfg.hidden_act, cfg.feat_extract_activation):
            if act not in ACTIVATIONS:
                raise NotImplementedError(f"activation {act!r} is not implemented")
        return cfg

    @property
    def stride(self) -> int:
        """Samples per output frame (320 for wav2vec2)."""
        return math.prod(self.conv_stride)

    def num_frames(self, n_samples):
        """The conv stack's output length for ``n_samples`` input samples
        (an int, or an integer tensor of lengths)."""
        n = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            n = (n - k) // s + 1
        return n


XLSR53 = Wav2Vec2Config()


def _layer_norm(cfg: Wav2Vec2Config, width: int) -> nn.LayerNorm:
    return nn.LayerNorm(width, eps=cfg.layer_norm_eps)


class LayerNormConvLayer(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config, layer_id: int):
        super().__init__()
        c_in = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        c_out = cfg.conv_dim[layer_id]
        self.conv = nn.Conv1d(c_in, c_out, cfg.conv_kernel[layer_id],
                              stride=cfg.conv_stride[layer_id],
                              bias=cfg.conv_bias)
        self.layer_norm = _layer_norm(cfg, c_out)
        self.act = ACTIVATIONS[cfg.feat_extract_activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) → (B, C_out, T')."""
        x = self.conv(x)
        x = self.layer_norm(x.transpose(1, 2)).transpose(1, 2)
        return self.act(x)


class FeatureEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            LayerNormConvLayer(cfg, i) for i in range(len(cfg.conv_dim)))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        """Waveforms (B, T) → conv features (B, T', C), time-major as in
        Flax."""
        with scope("w2v_conv"):
            x = input_values[:, None, :]
            for layer in self.conv_layers:
                x = layer(x)
            return x.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = _layer_norm(cfg, cfg.conv_dim[-1])
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with scope("w2v_conv"):
            return self.projection(self.layer_norm(x))


class ConvWithWeightNorm(nn.Module):
    """The positional conv: ``weight_v / ‖weight_v‖ · weight_g`` with one
    norm per kernel tap (over the output and input axes)."""

    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        H, G, K = (cfg.hidden_size, cfg.num_conv_pos_embedding_groups,
                   cfg.num_conv_pos_embeddings)
        self.groups, self.padding = G, K // 2
        self.weight_v = nn.Parameter(torch.empty(H, H // G, K))
        self.weight_g = nn.Parameter(torch.empty(1, 1, K))
        self.bias = nn.Parameter(torch.empty(H))

    def kernel(self) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.weight_v, dim=(0, 1), keepdim=True)
        return self.weight_v / norm * self.weight_g

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, T) → (B, H, T + 2·(K//2) − K + 1)."""
        return F.conv1d(x, self.kernel(), self.bias, padding=self.padding,
                        groups=self.groups)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.conv = ConvWithWeightNorm(cfg)
        self.num_pad_remove = 1 if cfg.num_conv_pos_embeddings % 2 == 0 else 0
        self.act = ACTIVATIONS[cfg.feat_extract_activation]

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """(B, T, H) → (B, T, H)."""
        with scope("w2v_pos_conv"):
            x = self.conv(h.transpose(1, 2))
            if self.num_pad_remove:
                x = x[..., :-self.num_pad_remove]
            return self.act(x).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads, self.head_dim = heads, width // heads
        if self.head_dim * heads != width:
            raise ValueError(f"width {width} is not divisible by {heads} heads")
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        return x.view(B, T, self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None = None
                ) -> torch.Tensor:
        """(B, T, W) → (B, T, W); ``bias`` broadcasts to (B, heads, T, T).
        As flax's ``dot_product_attention_weights``: the query is divided
        by √d before the product, the bias added, softmax over keys."""
        with scope("attention"):
            q = self._split(self.q_proj(x)) / math.sqrt(self.head_dim)
            k, v = self._split(self.k_proj(x)), self._split(self.v_proj(x))
            scores = q @ k.transpose(-1, -2)
            if bias is not None:
                scores = scores + bias
            out = torch.softmax(scores, dim=-1) @ v
            B, _, T, _ = out.shape
            return self.out_proj(out.transpose(1, 2).reshape(B, T, -1))


class FeedForward(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.intermediate_dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.output_dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with scope("ffn"):
            return self.output_dense(self.act(self.intermediate_dense(x)))


class EncoderLayerStableLayerNorm(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.layer_norm = _layer_norm(cfg, cfg.hidden_size)
        self.attention = Attention(cfg.hidden_size, cfg.num_attention_heads)
        self.final_layer_norm = _layer_norm(cfg, cfg.hidden_size)
        self.feed_forward = FeedForward(cfg)

    def forward(self, h: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        h = h + self.attention(self.layer_norm(h), bias)
        return h + self.feed_forward(self.final_layer_norm(h))


class StableLayerNormEncoder(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = _layer_norm(cfg, cfg.hidden_size)
        self.layers = nn.ModuleList(EncoderLayerStableLayerNorm(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, h: torch.Tensor, frame_mask: torch.Tensor | None = None,
                keep: int | None = None) -> list[torch.Tensor]:
        """The hidden states (each (B, T, H)): every layer's input, then
        the last layer's output after the final LayerNorm.  ``keep`` keeps
        only the last ``keep`` of them (the others are freed as the layers
        run)."""
        bias = None
        if frame_mask is not None:
            h = h.masked_fill(~frame_mask[:, :, None], 0.0)
            bias = torch.zeros(frame_mask.shape, dtype=h.dtype, device=h.device)
            bias = bias.masked_fill(~frame_mask, torch.finfo(h.dtype).min)
            bias = bias[:, None, None, :]
        h = h + self.pos_conv_embed(h)
        n_states = len(self.layers) + 1
        keep = n_states if keep is None else keep
        states = []
        for i, layer in enumerate(self.layers):
            if i >= n_states - keep:
                states.append(h)
            h = layer(h, bias)
        states.append(self.layer_norm(h))
        return states


class Wav2Vec2Model(nn.Module):
    """The bare wav2vec2 model: waveforms (B, T) → hidden states."""

    def __init__(self, cfg: Wav2Vec2Config = XLSR53):
        super().__init__()
        self.config = cfg
        self.feature_extractor = FeatureEncoder(cfg)
        self.feature_projection = FeatureProjection(cfg)
        self.masked_spec_embed = nn.Parameter(torch.empty(cfg.hidden_size))
        self.encoder = StableLayerNormEncoder(cfg)

    def frame_mask(self, n_frames: int, attention_mask: torch.Tensor) -> torch.Tensor:
        """A sample mask (B, T) → the frame mask (B, n_frames): the frames
        before the conv output length of the valid samples."""
        lengths = self.config.num_frames(attention_mask.long().sum(-1))
        return (torch.arange(n_frames, device=attention_mask.device)[None]
                < lengths[:, None])

    def forward(self, input_values: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                keep: int | None = None) -> list[torch.Tensor]:
        """Waveforms (B, T) and an optional sample mask (B, T) → the
        hidden states, each (B, T', H) (``StableLayerNormEncoder``)."""
        feats = self.feature_extractor(input_values)
        mask = (None if attention_mask is None
                else self.frame_mask(feats.shape[1], attention_mask))
        return self.encoder(self.feature_projection(feats), mask, keep)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "Wav2Vec2Model":
        """Random weights drawn from ``generator`` on the module's device
        (He-normal convs, normal(0.02) dense kernels, zero biases, unit
        LayerNorms, ``weight_g`` the per-tap norm of ``weight_v``), as
        transformers' Flax initialisers draw them."""
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if name.endswith("weight_g"):
                continue
            if isinstance(self.get_submodule(name.rpartition(".")[0]), nn.LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "masked_spec_embed":
                p.uniform_(0.0, 0.01, generator=generator)
            elif p.ndim == 3:  # conv kernels: He normal over fan-in
                fan_in = p.shape[1] * p.shape[2]
                p.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            else:
                p.normal_(0.0, std, generator=generator)
        conv = self.encoder.pos_conv_embed.conv
        conv.weight_g.copy_(torch.linalg.vector_norm(conv.weight_v, dim=(0, 1),
                                                     keepdim=True))
        return self
