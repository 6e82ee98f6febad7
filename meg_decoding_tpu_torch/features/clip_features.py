"""CLIP image features.  Port of ``meg_decoding_tpu/features/clip_features.py``.

Reference: ``examples/create_imagenet_features.py:16-52`` — CLIP ViT-B/32
``encode_image`` over GOD / ImageNet-val images, saved as the .npy/.pkl
galleries consumed by the GOD losses (``loss.py:149-166``) and the
distractor evaluation.

The network is the port's own vision tower (``features/clip_model.py``);
the JAX package runs transformers' Flax CLIP.  ``load_clip`` has the
backends of ``features/wav2vec.py:load_wav2vec`` (``random``, ``hf``,
``auto``).

The resize is ``jax.image.resize(..., "bicubic")``'s, which the JAX
package uses: the Keys cubic kernel with a = −0.5, widened by the
downscale factor when shrinking (``antialias=True``), each output pixel a
normalised weighted sum of the input pixels.  The two separable weight
matrices are built as ``jax.image.scale_and_translate`` builds them and
applied as two matmuls.  (``torch.nn.functional.interpolate``'s bicubic
uses a = −0.75 and no antialiasing, and gives other pixels.)
"""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features import hf_checkpoint
from meg_decoding_tpu_torch.features.clip_model import (
    VIT_B32,
    CLIPImageEncoder,
    CLIPVisionConfig,
)

__all__ = ["load_clip", "encode_images", "preprocess_images",
           "resize_weights"]

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_SIZE = 224
_PREPROCESS_BATCH = 128  # images resized at once (bounds the f32 copies)


def load_clip(model_name: str = "openai/clip-vit-base-patch32",
              backend: str = "auto", device: str | torch.device = "cuda",
              seed: int = 0) -> CLIPImageEncoder:
    """The image encoder on ``device``, in eval mode, without gradients.
    backend: 'hf' | 'random' | 'auto' (``hf_checkpoint.load_encoder``;
    ``seed`` only affects 'random')."""
    dev = resolve_device(device)

    def build(cfg=VIT_B32):
        with dev:
            return CLIPImageEncoder(cfg)

    return hf_checkpoint.load_encoder(
        model_name, backend, build, CLIPVisionConfig.from_dict,
        lambda m: m.init_random(torch.Generator(device=dev).manual_seed(int(seed))),
        "clip")


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """The Keys cubic kernel, a = −0.5, at distances x ≥ 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(in_size: int, out_size: int,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """The (in_size, out_size) f32 matrix of ``jax.image.resize``'s bicubic
    along one axis (``compute_weight_mat`` with scale out/in, no
    translation, antialiased): output = input @ weights."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32,
                                        device=device)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def preprocess_images(images, device: str | torch.device = "cuda"
                      ) -> torch.Tensor:
    """uint8 (N, H, W, 3) → CLIP-normalized f32 (N, 224, 224, 3) on
    ``device``.

    CLIP's official preprocessing: resize the SHORTEST side to 224
    (bicubic), then center-crop 224×224 — a straight resize would squash
    non-square images and skew features vs reference-built galleries.  An
    axis already of its target length is not resampled (as in
    ``jax.image.resize``); the crop is taken from the weight matrices'
    columns, which gives the same pixels as cropping the resized image."""
    dev = resolve_device(device)
    x = images if torch.is_tensor(images) else torch.from_numpy(np.asarray(images))
    N, H, W = x.shape[:3]
    scale = _SIZE / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    top, left = (nh - _SIZE) // 2, (nw - _SIZE) // 2
    wh = resize_weights(H, nh, dev)[:, top:top + _SIZE] if nh != H else None
    ww = resize_weights(W, nw, dev)[:, left:left + _SIZE] if nw != W else None
    mean = torch.tensor(_CLIP_MEAN, device=dev)
    std = torch.tensor(_CLIP_STD, device=dev)
    out = torch.empty((N, _SIZE, _SIZE, 3), dtype=torch.float32, device=dev)
    for i in range(0, N, _PREPROCESS_BATCH):
        b = x[i:i + _PREPROCESS_BATCH].to(dev, torch.float32) / 255.0
        b = (torch.einsum("nhwc,ho->nowc", b, wh) if wh is not None
             else b[:, top:top + _SIZE])
        b = (torch.einsum("nowc,wp->nopc", b, ww) if ww is not None
             else b[:, :, left:left + _SIZE])
        out[i:i + _PREPROCESS_BATCH] = (b - mean) / std
    return out


@torch.no_grad()
def encode_images(model: CLIPImageEncoder, images,
                  batch_size: int = 64) -> torch.Tensor:
    """Normalized images (N, 224, 224, 3) → (N, 512) image features on the
    model's device."""
    dev = next(model.parameters()).device
    images = torch.as_tensor(images)
    feats = []
    for i in range(0, len(images), batch_size):
        batch = images[i:i + batch_size].to(dev, torch.float32)
        feats.append(model.get_image_features(batch.permute(0, 3, 1, 2)))
    return torch.cat(feats, dim=0)
