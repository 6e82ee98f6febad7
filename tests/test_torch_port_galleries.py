"""The port's feature-gallery builder (``cli/create_image_features.py``)
against the JAX package's ``examples/create_imagenet_features.py``, on the
CPU: the per-image resize against ``jax.image.resize``'s bicubic on
odd-sized images, upscaled and downscaled, and the CLI end to end on a
small image directory with one set of random CLIP weights carried from
Flax to the port (``interop.encoder_params_from_flax``; the tiny tower of
``tests/test_torch_port_features.py``).

Tolerances, each with its reason:
* the resized image, f32 in [0, 255] — 4e-3 absolute (1.6e-5 of the
  range: two separable f32 passes of up to ~8 taps each, a shrink's
  antialiased kernel the widest, against XLA's resize; 2.7e-3 measured);
* the uint8 images — at most 1 apart, on at most 0.1 % of the pixels (a
  value within that rounding of an integer truncates either way);
* the gallery — the features test's 1e-4·max|ref| (f32 encoders).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_port_features import RTOL, _rel, clip  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(37, 53), (301, 257), (375, 500), (225, 224)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_resize(im):
    """The JAX example's geometry (``load_image_dir``, ``:44-58``)."""
    H, W = im.shape[:2]
    scale = 224.0 / min(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    x = jax.image.resize(jnp.asarray(im, jnp.float32)[None], (1, nh, nw, 3),
                         method="bicubic")
    top, left = (nh - 224) // 2, (nw - 224) // 2
    return np.asarray(jnp.clip(x[0, top:top + 224, left:left + 224, :], 0, 255))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_matches_jax_image_resize(shape):
    from meg_decoding_tpu_torch.cli.create_image_features import (
        resize_shortest_crop,
    )

    im = np.random.RandomState(sum(shape)).randint(0, 256, (*shape, 3)).astype(np.uint8)
    got = resize_shortest_crop(im, device="cpu").numpy()
    want = _jax_resize(im)
    assert got.shape == want.shape == (224, 224, 3)
    assert np.abs(got - want).max() <= 4e-3


def _example():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_gallery_example", os.path.join(ROOT, "examples",
                                            "create_imagenet_features.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gallery_cli_matches_jax_example(clip, tmp_path, monkeypatch):
    from matplotlib.image import imsave

    from meg_decoding_tpu_torch.cli import create_image_features as cli

    flax_model, params, model = clip
    rng = np.random.RandomState(3)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for i, shape in enumerate(SHAPES + [(240, 230)]):
        im = rng.randint(0, 256, (*shape, 3)).astype(np.uint8)
        imsave(str(img_dir / f"img{i:02d}.png"), im[..., 0] if i == 4 else im,
               cmap="gray" if i == 4 else None)
    (img_dir / "notes.txt").write_text("not an image")

    example = _example()
    want_imgs = example.load_image_dir(str(img_dir))
    got_imgs = cli.load_image_dir(str(img_dir), device="cpu").numpy()
    assert got_imgs.shape == want_imgs.shape == (5, 224, 224, 3)
    diff = np.abs(got_imgs.astype(int) - want_imgs.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3

    monkeypatch.setattr(example, "load_clip", lambda backend: (flax_model, params))
    monkeypatch.setattr(cli, "load_clip", lambda **kw: model)
    jout, tout = tmp_path / "jax.npy", tmp_path / "torch.npy"
    monkeypatch.setattr(sys, "argv", ["x", str(img_dir), str(jout), "random"])
    example.main()
    got = cli.main([str(img_dir), str(tout), "random", "--device", "cpu"])
    want = np.load(jout)
    np.testing.assert_array_equal(np.load(tout), got)
    assert got.shape == want.shape == (5, 24)
    assert _rel(torch.from_numpy(got), want) <= RTOL


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_matches_matplotlib(tmp_path, channels):
    """``utils/png.py`` against matplotlib's ``imread`` (Pillow) on files
    Pillow wrote (its adaptive filters: Sub, Up, Average, Paeth), and its
    own writer's files read back exactly."""
    from PIL import Image

    from meg_decoding_tpu_torch.utils.png import read_png, write_png

    rng = np.random.RandomState(channels)
    im = rng.randint(0, 256, (23, 31, channels)).astype(np.uint8)
    im[5:15] = im[5:6]  # repeated rows: Up and Average predict them
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    path = str(tmp_path / "pil.png")
    Image.fromarray(im[..., 0] if channels == 1 else im, mode).save(path)
    from matplotlib.image import imread

    want = np.round(imread(path) * 255).astype(np.uint8)
    if channels == 2:  # matplotlib gives grey + alpha as RGBA
        want = want[..., [0, 3]]
    got = read_png(path)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    for f in (0, 2):
        write_png(str(tmp_path / f"own{f}.png"), im, filter_type=f)
        np.testing.assert_array_equal(read_png(str(tmp_path / f"own{f}.png")), im)


def test_gallery_cli_refuses_an_empty_directory(tmp_path):
    from meg_decoding_tpu_torch.cli import create_image_features as cli

    with pytest.raises(FileNotFoundError, match="no images"):
        cli.load_image_dir(str(tmp_path), device="cpu")
