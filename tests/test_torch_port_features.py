"""The port's stimulus encoders against the JAX package, on the CPU:
``features/wav2vec2_model.py`` + ``features/wav2vec.py`` against
transformers' ``FlaxWav2Vec2Model`` through ``meg_decoding_tpu/features/
wav2vec.py``, and ``features/clip_model.py`` + ``features/clip_features.py``
against ``FlaxCLIPModel`` through ``meg_decoding_tpu/features/
clip_features.py``, with the Flax weights carried by
``interop.encoder_params_from_flax``; then the ``hf`` loader on checkpoints
written by transformers' ``save_pretrained``, against transformers' torch
models.

Configurations: wav2vec2 at ``tests/test_wav2vec_torch_oracle.py``'s tiny
size (hidden 32, 4 layers, 2 heads, conv (8, 8), kernels (3, 3), strides
(2, 2), positional conv K = 16 in 4 groups) with the xlsr-53 structure
(stable layer norm, layer-normed convs); CLIP's vision tower 32 wide, 3
layers, 2 heads, 32×32 patches of 224×224 images, projection 24.  Every
bias, LayerNorm and ``weight_g`` is drawn at random (not the initialisers'
zeros and ones) so that padded frames are not zero and the weight norm is
not the identity: otherwise a broken mask or weight-norm rule could not
show.

Tolerances, each with its reason (f32 throughout; XLA and torch sum in
other orders):
* every hidden state, ``embed_last4_avg`` and ``embed_features`` —
  max|Δ| ≤ 1e-5·max|ref|;
* ``get_image_features`` — ≤ 1e-5 relative to max|ref|;
* ``preprocess_images`` — ≤ 1e-5 absolute: two f32 evaluations of the
  same weights (XLA fuses the weight computation into its resize, the
  port builds the matrices apart), then the normalisation divides by
  std ≈ 0.26;
* the ``hf`` loader against transformers' torch models — ≤ 1e-5 relative.

Four rules each have a check that fails when the rule is broken: the
stable-LN rule (only the last hidden state normalised), the masks (a
masked chunk differs from the unmasked one), the per-tap weight norm (a
per-channel norm gives another kernel) and the antialiased a = −0.5
bicubic resize (``torch.nn.functional.interpolate`` gives other pixels).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from transformers import (
    CLIPConfig,
    CLIPModel,
    CLIPTextConfig,
    CLIPVisionConfig as HFVisionConfig,
    FlaxCLIPModel,
    FlaxWav2Vec2Model,
    Wav2Vec2Config as HFWav2Vec2Config,
    Wav2Vec2Model as HFWav2Vec2Model,
)

from meg_decoding_tpu.features import clip_features as jclip
from meg_decoding_tpu.features import wav2vec as jw2v
from meg_decoding_tpu_torch.features import clip_features, wav2vec
from meg_decoding_tpu_torch.features.clip_model import (
    CLIPImageEncoder,
    CLIPVisionConfig,
)
from meg_decoding_tpu_torch.features.wav2vec2_model import (
    Wav2Vec2Config,
    Wav2Vec2Model,
)
from meg_decoding_tpu_torch.interop import encoder_params_from_flax

RTOL = 1e-5
W2V = dict(hidden_size=32, num_hidden_layers=4, num_attention_heads=2,
           intermediate_size=64, do_stable_layer_norm=True,
           feat_extract_norm="layer", conv_dim=(8, 8), conv_kernel=(3, 3),
           conv_stride=(2, 2), num_conv_pos_embeddings=16,
           num_conv_pos_embedding_groups=4)
CLIP_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                   num_attention_heads=2, image_size=224, patch_size=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The suite runs one test file per worker process, several at once: a
    single intra-op thread keeps this file's torch work from competing
    with the other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_flax_params(port_cls, cfg, seed):
    """A Flax params tree for ``port_cls(cfg)`` drawn on the port's side
    (``init_random``, then every bias, LayerNorm and ``weight_g`` redrawn)
    and written in Flax's names and layouts by the inverse of the interop
    mapping, independent of it: the Flax models' own initialisation runs
    eagerly and takes longer than the tests that use it."""
    model = port_cls(cfg).init_random(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    tree = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rpartition(".")[0])
            stem, _, leaf = name.rpartition(".")
            a = p.clone()
            if leaf == "bias":
                a = 0.1 * torch.randn(a.shape, generator=g)
            elif isinstance(owner, torch.nn.LayerNorm) or leaf == "weight_g":
                a = a * (1.0 + 0.2 * torch.randn(a.shape, generator=g))
            a = a.numpy()
            if isinstance(owner, torch.nn.LayerNorm):
                leaf = "scale" if leaf == "weight" else leaf
            elif isinstance(owner, torch.nn.Embedding):
                leaf = "embedding"
            elif leaf == "weight":  # Dense / Conv kernels
                leaf = "kernel"
                a = a.T if a.ndim == 2 else np.transpose(
                    a, (2, 1, 0) if a.ndim == 3 else (2, 3, 1, 0))
            node = tree
            for part in stem.split(".") if stem else []:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(a)
    return tree


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def w2v():
    """(flax model, its perturbed params, the port's model with them)."""
    flax_model = FlaxWav2Vec2Model(HFWav2Vec2Config(vocab_size=16, **W2V),
                                   _do_init=False)
    cfg = Wav2Vec2Config.from_dict(W2V)
    params = _random_flax_params(Wav2Vec2Model, cfg, 3)
    model = Wav2Vec2Model(cfg)
    model.load_state_dict(encoder_params_from_flax(params, model))
    return flax_model, params, model.eval().requires_grad_(False)


def _wav(n, seed):
    return (np.random.RandomState(seed).randn(n) * 0.1).astype(np.float32)


def test_hidden_states_match_flax(w2v):
    """Every hidden state, unmasked; only the last is normalised (the
    stable-LN rule: normalising the one before, or not normalising the
    last, leaves the Flax states)."""
    flax_model, params, model = w2v
    wav = _wav(1600, 1)
    want = flax_model(jnp.asarray(wav)[None], params=params,
                      output_hidden_states=True, train=False).hidden_states
    got = model(torch.from_numpy(wav)[None])
    assert len(got) == len(want) == W2V["num_hidden_layers"] + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g[0], w[0]) <= RTOL, i
    ln = model.encoder.layer_norm
    assert _rel(ln(got[-2][0]), want[-2][0]) > 1e-2
    raw_last = model.encoder.layers[-1](got[-2], None)
    assert _rel(raw_last[0], want[-1][0]) > 1e-2


def test_masked_hidden_states_match_flax(w2v):
    """A zero-padded chunk with a sample mask: padded frames zeroed before
    the positional conv, padded keys masked in attention.  The mask
    matters here: the same chunk without it gives other states."""
    flax_model, params, model = w2v
    n_valid, chunk = 1100, 1600
    buf = np.zeros(chunk, np.float32)
    buf[:n_valid] = _wav(n_valid, 5)
    mask = (np.arange(chunk) < n_valid).astype(np.int32)
    want = flax_model(jnp.asarray(buf)[None], attention_mask=jnp.asarray(mask)[None],
                      params=params, output_hidden_states=True,
                      train=False).hidden_states
    got = model(torch.from_numpy(buf)[None], torch.from_numpy(mask)[None])
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g[0], w[0]) <= RTOL, i
    n_frames = int(model.config.num_frames(n_valid))
    unmasked = model(torch.from_numpy(buf)[None])
    assert _rel(unmasked[-1][0, :n_frames], want[-1][0, :n_frames]) > 1e-3


def test_weight_norm_is_per_kernel_tap(w2v):
    """``weight_g`` (1, 1, K) scales each tap's norm over (out, in/g): the
    kernel the Flax module applies.  A norm per output channel (torch's
    default ``weight_norm(dim=0)``) is another kernel."""
    _, params, model = w2v
    conv = params["encoder"]["pos_conv_embed"]["conv"]
    v, g = np.asarray(conv["weight_v"]), np.asarray(conv["weight_g"])
    want = v / np.linalg.norm(v, axis=(0, 1), keepdims=True) * g
    got = model.encoder.pos_conv_embed.conv.kernel()
    assert _rel(got, want) <= 1e-6
    per_channel = v / np.linalg.norm(v, axis=(1, 2), keepdims=True) * g
    assert _rel(per_channel, want) > 1e-2


def test_embed_last4_avg_matches_jax_over_chunks(w2v):
    """The chunked path: 0.025 s chunks (400 samples, 99 frames) with 8
    frames of overlap over 6,001 samples — many chunks, the last one
    zero-padded and masked; and the one-chunk path."""
    flax_model, params, model = w2v
    wav = _wav(6001, 3)
    kw = dict(chunk_sec=0.025, overlap_sec=0.002, sample_rate=16000)
    want = jw2v.embed_last4_avg(flax_model, params, wav, **kw)
    got = wav2vec.embed_last4_avg(model, wav, **kw)
    assert got.shape == want.shape == (32, int(model.config.num_frames(6001)))
    assert _rel(got, want) <= RTOL
    short = _wav(1200, 2)
    assert _rel(wav2vec.embed_last4_avg(model, short),
                jw2v.embed_last4_avg(flax_model, params, short)) <= RTOL


def test_embed_features_matches_jax(w2v):
    flax_model, params, model = w2v
    wav = _wav(1999, 0)
    got = wav2vec.embed_features(model, wav)
    want = jw2v.embed_features(flax_model, params, wav)
    assert got.shape == want.shape == (8, int(model.config.num_frames(1999)))
    assert _rel(got, want) <= RTOL


def test_chunk_too_short_for_its_overlap_raises(w2v):
    _, _, model = w2v
    with pytest.raises(ValueError, match="walk backwards"):
        wav2vec.embed_last4_avg(model, _wav(2000, 0), chunk_sec=0.003,
                                overlap_sec=0.002)


def test_frame_accounting_matches_the_conv_stack():
    assert wav2vec.w2v_output_rate() == 50.0
    cfg = Wav2Vec2Config()
    for n in (400, 16000, 320000, 320000 + 123):
        assert wav2vec._num_frames(cfg, n) == jw2v._num_frames(cfg, n)
    assert wav2vec._num_frames(cfg, 320000) == 999 and cfg.stride == 320


@pytest.fixture(scope="module")
def clip():
    cfg = CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(hidden_size=16, intermediate_size=32,
                       num_hidden_layers=1, num_attention_heads=2,
                       max_position_embeddings=16, vocab_size=99),
        HFVisionConfig(**CLIP_VISION), projection_dim=24)
    flax_model = FlaxCLIPModel(cfg, _do_init=False)
    vision_cfg = CLIPVisionConfig.from_dict(cfg.to_dict())
    params = _random_flax_params(CLIPImageEncoder, vision_cfg, 9)
    params["logit_scale"] = np.float32(2.6592)  # a parameter of the module's setup
    model = CLIPImageEncoder(vision_cfg)
    model.load_state_dict(encoder_params_from_flax(params, model))
    return flax_model, params, model.eval().requires_grad_(False)


def test_image_features_match_jax(clip):
    flax_model, params, model = clip
    rng = np.random.RandomState(0)
    pixels = jclip.preprocess_images(
        rng.randint(0, 256, (5, 224, 224, 3)).astype(np.uint8))
    want = jclip.encode_images(flax_model, params, pixels)
    got = clip_features.encode_images(model, torch.from_numpy(pixels),
                                      batch_size=3)
    assert got.shape == want.shape == (5, 24)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("shape", [(224, 224), (375, 500), (300, 200),
                                   (100, 150)])
def test_preprocess_images_matches_jax(shape):
    """Shortest side to 224 (antialiased Keys bicubic, a = −0.5), centre
    crop, CLIP normalisation: at GOD's 375 × 500, a portrait image, an
    upscale, and the identity size."""
    imgs = np.random.RandomState(sum(shape)).randint(
        0, 256, (3, *shape, 3)).astype(np.uint8)
    want = jclip.preprocess_images(imgs)
    got = clip_features.preprocess_images(imgs, device="cpu")
    assert got.shape == want.shape == (3, 224, 224, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5


def test_resize_is_not_torch_bicubic():
    """``interpolate(mode='bicubic')`` (a = −0.75, no antialiasing) gives
    other pixels than ``jax.image.resize``'s bicubic, which the weight
    matrices reproduce."""
    x = np.random.RandomState(7).rand(1, 375, 500, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 224, 299, 3),
                                       method="bicubic"))
    t = torch.from_numpy(x)
    wh = clip_features.resize_weights(375, 224)
    ww = clip_features.resize_weights(500, 299)
    got = torch.einsum("nowc,wp->nopc", torch.einsum("nhwc,ho->nowc", t, wh), ww)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5
    torch_bicubic = torch.nn.functional.interpolate(
        t.permute(0, 3, 1, 2), size=(224, 299), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1)
    assert float(np.abs(torch_bicubic.numpy() - want).max()) > 1e-2


# --- the hf backend ----------------------------------------------------------

@pytest.fixture(scope="module")
def hf_wav2vec(tmp_path_factory):
    """A transformers-torch wav2vec2 at the tiny size, saved with
    safetensors and with a pickled state_dict."""
    torch.manual_seed(0)
    ref = HFWav2Vec2Model(HFWav2Vec2Config(vocab_size=16, **W2V)).eval()
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.1)
    dirs = {}
    for safe in (True, False):
        d = str(tmp_path_factory.mktemp(f"w2v_safe{safe}"))
        ref.save_pretrained(d, safe_serialization=safe)
        dirs[safe] = d
    return ref, dirs


@pytest.mark.parametrize("safe", [True, False])
def test_hf_wav2vec_checkpoint_matches_transformers(hf_wav2vec, safe):
    ref, dirs = hf_wav2vec
    model = wav2vec.load_wav2vec(dirs[safe], backend="hf", device="cpu")
    wav = _wav(1600, 4)
    with torch.no_grad():
        want = ref(torch.from_numpy(wav)[None],
                   output_hidden_states=True).hidden_states
    got = model(torch.from_numpy(wav)[None])
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= RTOL, i


def test_hf_loader_takes_the_legacy_weight_norm_names(hf_wav2vec, tmp_path):
    """``weight_g``/``weight_v`` (older checkpoints, xlsr-53's own) and a
    ``wav2vec2.`` prefix (pre-training heads), from a hub-cache snapshot."""
    ref, dirs = hf_wav2vec
    sd = {}
    for k, v in ref.state_dict().items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        sd["wav2vec2." + k] = v
    sd["quantizer.codevectors"] = torch.zeros(3)
    repo = tmp_path / "hub" / "models--org--tiny-w2v"
    snap = repo / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123")
    torch.save(sd, snap / "pytorch_model.bin")
    with open(os.path.join(dirs[True], "config.json")) as f:
        (snap / "config.json").write_text(f.read())
    os.environ["HF_HUB_CACHE"] = str(tmp_path / "hub")
    try:
        model = wav2vec.load_wav2vec("org/tiny-w2v", backend="hf", device="cpu")
    finally:
        del os.environ["HF_HUB_CACHE"]
    want = wav2vec.load_wav2vec(dirs[True], backend="hf", device="cpu")
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_hf_clip_checkpoint_matches_transformers(tmp_path):
    cfg = CLIPConfig.from_text_vision_configs(
        CLIPTextConfig(hidden_size=16, intermediate_size=32,
                       num_hidden_layers=1, num_attention_heads=2,
                       max_position_embeddings=16, vocab_size=99),
        HFVisionConfig(**CLIP_VISION), projection_dim=24)
    torch.manual_seed(1)
    ref = CLIPModel(cfg).eval()
    ref.save_pretrained(str(tmp_path), safe_serialization=True)
    model = clip_features.load_clip(str(tmp_path), backend="hf", device="cpu")
    pixels = torch.randn(2, 3, 224, 224)
    with torch.no_grad():
        want = ref.get_image_features(pixel_values=pixels)
    assert _rel(model.get_image_features(pixels), want) <= RTOL


def test_auto_backend_falls_back_loudly_to_random(tmp_path, capsys):
    model = wav2vec.load_wav2vec(str(tmp_path / "absent"), backend="auto",
                                 num_hidden_layers=1, device="cpu")
    assert "RANDOMLY INITIALIZED" in capsys.readouterr().out
    assert model.config.hidden_size == 1024 and len(model.encoder.layers) == 1
    again = wav2vec.load_wav2vec(backend="random", num_hidden_layers=1,
                                 device="cpu")
    for k, v in again.state_dict().items():  # one seed, one set of weights
        assert torch.equal(model.state_dict()[k], v), k
    emb = wav2vec.embed_last4_avg(model, _wav(3200, 0))
    assert emb.shape == (1024, 9) and bool(torch.isfinite(emb).all())
    with pytest.raises(FileNotFoundError):
        wav2vec.load_wav2vec(str(tmp_path / "absent"), backend="hf",
                             device="cpu")
    clip_model = clip_features.load_clip(str(tmp_path / "absent"),
                                         backend="auto", device="cpu")
    assert "RANDOMLY INITIALIZED" in capsys.readouterr().out
    assert clip_model.config.projection_dim == 512
    assert clip_model.config.num_positions == 50
