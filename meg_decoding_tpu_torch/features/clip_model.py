"""CLIP's vision tower and image projection as a torch module.

The JAX package runs transformers' Flax ``FlaxCLIPModel``
(``meg_decoding_tpu/features/clip_features.py:load_clip``), default
configuration ViT-B/32, and calls only ``get_image_features``; the text
tower is never used, so this module leaves it out.  It keeps the Flax
module tree and parameter names (``interop.py`` maps Flax and
transformers-torch weights onto it):

* ``vision_model.embeddings`` — ``patch_embedding`` (a 32×32, stride-32
  Conv2d without bias), ``class_embedding`` (H,), ``position_embedding``
  (50 positions: the class token and 7×7 patches);
* ``vision_model.pre_layrnorm`` (transformers' spelling);
* ``vision_model.encoder.layers.{i}`` — pre-LN blocks: ``layer_norm1`` →
  ``self_attn`` → residual, ``layer_norm2`` → ``mlp`` (``fc1``,
  quick GELU x·σ(1.702x), ``fc2``) → residual; 12 layers, 768 wide, 12
  heads, FFN 3072;
* ``vision_model.post_layernorm`` on the class token;
* ``visual_projection`` 768 → 512, without bias.

Every LayerNorm uses eps 1e-5.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from meg_decoding_tpu_torch.features.wav2vec2_model import ACTIVATIONS, Attention

__all__ = ["CLIPVisionConfig", "CLIPImageEncoder", "VIT_B32"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The vision tower's hyper-parameters, with transformers' key names;
    the defaults are ``CLIPConfig()``'s (ViT-B/32, 512-d projection)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    initializer_range: float = 0.02
    projection_dim: int = 512

    @classmethod
    def from_dict(cls, d: dict) -> "CLIPVisionConfig":
        """From a transformers CLIP ``config.json``: its ``vision_config``
        and the top-level ``projection_dim`` (unknown keys ignored)."""
        names = {f.name for f in dataclasses.fields(cls)}
        vision = dict(d.get("vision_config") or {})
        if "projection_dim" in d:
            vision["projection_dim"] = d["projection_dim"]
        cfg = cls(**{k: v for k, v in vision.items() if k in names})
        if cfg.hidden_act not in ACTIVATIONS:
            raise NotImplementedError(
                f"activation {cfg.hidden_act!r} is not implemented")
        return cfg

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


VIT_B32 = CLIPVisionConfig()


class Embeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.empty(H))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, H, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions, H)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) → (B, 50, H): the class token, then the patches
        row by row, plus the position embeddings."""
        patches = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        return torch.cat([cls, patches], dim=1) + self.position_embedding.weight


class MLP(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.act = ACTIVATIONS[cfg.hidden_act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.self_attn = Attention(H, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.mlp = MLP(cfg)
        self.layer_norm2 = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(self.layer_norm1(h))
        return h + self.mlp(self.layer_norm2(h))


class Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            h = layer(h)
        return h


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        H = cfg.hidden_size
        self.embeddings = Embeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.encoder = Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, 224, 224) → the pooled output (B, H): the class token of
        the last layer, after ``post_layernorm``."""
        h = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return self.post_layernorm(h[:, 0, :])


class CLIPImageEncoder(nn.Module):
    """``vision_model`` and ``visual_projection`` of a CLIP model."""

    def __init__(self, cfg: CLIPVisionConfig = VIT_B32):
        super().__init__()
        self.config = cfg
        self.vision_model = VisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                           bias=False)

    def get_image_features(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """Normalised pixels (B, 3, 224, 224) → image features (B, P)."""
        return self.visual_projection(self.vision_model(pixel_values))

    forward = get_image_features

    @torch.no_grad()
    def init_random(self, generator: torch.Generator) -> "CLIPImageEncoder":
        """Random weights drawn from ``generator`` on the module's device:
        normal(0.02) kernels and embeddings, zero biases, unit LayerNorms."""
        std = self.config.initializer_range
        for name, p in self.named_parameters():
            if isinstance(self.get_submodule(name.rpartition(".")[0]), nn.LayerNorm):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, std, generator=generator)
        return self
