"""Build CLIP image-feature galleries (GOD / ImageNet-val distractors).
Port of ``examples/create_imagenet_features.py``.

Reference: ``examples/create_imagenet_features.py:16-52`` — CLIP ViT-B/32
image features over an image directory, saved to ``.npy`` for the GOD
losses (``image_features_train.npy`` 1200×512, ``image_features.npy``
50×512) and the ImageNet-val distractor gallery.

Each image (PNG/JPEG/BMP, sorted by name; PNGs read without an imaging
library, ``utils/png.py``, the others through Pillow; grey expanded to
RGB, alpha dropped) is resized so that its SHORTEST side is 224, with
``jax.image.resize``'s bicubic as the JAX example uses it (the Keys
kernel, a = −0.5, antialiased when it shrinks:
``features/clip_features.py:resize_weights``, not ``F.interpolate``'s
a = −0.75 without antialiasing), centre-cropped to 224×224, clipped to
[0, 255] and cut to uint8 (truncation, as ``astype``); then
``preprocess_images`` and ``encode_images`` on ``device`` with the port's
ViT-B/32 (``load_clip``: ``backend`` hf, random or auto).

Run: ``python -m meg_decoding_tpu_torch.cli.create_image_features
IMAGE_DIR OUT.npy [BACKEND] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features.clip_features import (
    encode_images,
    load_clip,
    preprocess_images,
    resize_weights,
)
from meg_decoding_tpu_torch.utils.png import read_png

__all__ = ["load_image_dir", "resize_shortest_crop", "main"]

_SIZE = 224
_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def resize_shortest_crop(im, device: str | torch.device = "cuda") -> torch.Tensor:
    """One image (H, W, 3) → (224, 224, 3) f32 on ``device``: bicubic
    resize of the shortest side to 224 (``jax.image.resize``'s), centre
    crop, clipped to [0, 255].  An axis already at its size is not
    resampled, as in ``jax.image.resize``."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(im), dtype=torch.float32, device=dev)
    H, W = x.shape[:2]
    scale = float(_SIZE) / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    top, left = (nh - _SIZE) // 2, (nw - _SIZE) // 2
    x = (torch.einsum("hwc,ho->owc", x, resize_weights(H, nh, dev)) if nh != H
         else x)[top:top + _SIZE]
    x = (torch.einsum("owc,wp->opc", x, resize_weights(W, nw, dev)) if nw != W
         else x)[:, left:left + _SIZE]
    return torch.clamp(x, 0, 255)


def _read(path: str) -> np.ndarray:
    """uint8 (H, W, 3): a PNG through ``utils/png.py`` (the values
    matplotlib's ``imread`` gives the JAX example, without an imaging
    library), any other format through Pillow; grey expanded to RGB, alpha
    dropped."""
    if path.lower().endswith(".png"):
        im = read_png(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"{path}: reading this format needs Pillow; "
                               "PNG files are read without it") from e
        with Image.open(path) as f:
            im = np.asarray(f)
    if im.ndim == 3 and im.shape[-1] <= 2:  # grey, grey + alpha
        im = im[..., 0]
    if im.ndim == 2:
        im = np.stack([im] * 3, -1)
    return im[..., :3]


def load_image_dir(image_dir: str, device: str | torch.device = "cuda"
                   ) -> torch.Tensor:
    """Every image of ``image_dir`` (sorted) → uint8 (N, 224, 224, 3) on
    ``device`` (``resize_shortest_crop``, then truncation to uint8)."""
    paths = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                   if f.lower().endswith(_EXTS))
    if not paths:
        raise FileNotFoundError(f"no images under {image_dir}")
    return torch.stack([resize_shortest_crop(_read(p), device).to(torch.uint8)
                        for p in paths])


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image_dir")
    ap.add_argument("out_path")
    ap.add_argument("backend", nargs="?", default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the random backend's weights")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    images = load_image_dir(args.image_dir, dev)
    model = load_clip(backend=args.backend, device=dev, seed=args.seed)
    feats = encode_images(model, preprocess_images(images, dev)).cpu().numpy()
    np.save(args.out_path, feats)
    print(f"saved {feats.shape} features to {args.out_path}")
    return feats


if __name__ == "__main__":
    main()
