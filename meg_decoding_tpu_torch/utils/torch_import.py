"""Import trained reference checkpoints (torch ``state_dict``s) into the
port's modules.  Port of ``meg_decoding_tpu/utils/torch_import.py``.

A user of arayabrain/MEG-decoding arrives with ``model_last.pt`` files saved
by the reference trainers (``train.py:271``: ``torch.save(
brain_encoder.state_dict(), ...)``).  This module maps those state_dicts,
by the reference's own module names (``models.py:340-361``:
``subject_block.spatial_attention.z``, ``conv_blocks.conv{k}.*``,
``conv_final1/2``), onto the port's state_dict names (flax's, see
``interop.py``).  Both sides are torch, so the map is a rename, a reshape
and the split of the complex ``z``; the result equals, bit for bit, what
the JAX package's importer followed by ``interop.params_from_jax`` gives.

Each ``*_from_state_dict`` returns a state_dict in the port's names: what
``model.load_state_dict`` takes, and what the port's evaluators and its
export CLI load as a checkpoint (``torch.save`` it as ``model.pt``; a
``loss.temp`` entry may be added).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_dict_to_numpy", "brain_encoder_from_state_dict",
           "eegnet_from_state_dict", "linear_encoder_from_state_dict",
           "load_torch_checkpoint"]


def load_torch_checkpoint(path: str, allow_pickle: bool = False) -> dict:
    """``torch.load`` a reference checkpoint → ``{name: CPU tensor}``.

    ``weights_only=True`` first: a plain ``state_dict`` (what the reference
    trainers save, ``train.py:274``) loads without unpickling code.  A
    checkpoint holding a whole pickled ``nn.Module`` cannot: pass
    ``allow_pickle=True`` to retry with full unpickling if you trust the
    file (it runs the pickle's code); the module's ``state_dict()`` is then
    taken."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):  # a whole module was saved
        sd = sd.state_dict()
    return {k: v.detach().cpu() if torch.is_tensor(v) else torch.as_tensor(v)
            for k, v in sd.items()}


def state_dict_to_numpy(sd: dict) -> dict:
    """``{name: tensor}`` → ``{name: np.ndarray}``."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in sd.items()}


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().cpu()


def _f32(a) -> torch.Tensor:
    return _t(a).to(torch.float32).contiguous()


def _conv1x1(w) -> torch.Tensor:
    """torch Conv1d weight (out, in, 1) → the port's (out, in)."""
    w = _t(w)
    if w.dim() != 3 or w.shape[-1] != 1:
        raise ValueError(f"expected a 1×1 Conv1d weight, got {tuple(w.shape)}")
    return _f32(w[:, :, 0])


def brain_encoder_from_state_dict(sd: dict, num_blocks: int = 5) -> dict:
    """Reference BrainEncoder state_dict → the port's ``BrainEncoder``
    state_dict.

    Name map (reference → port):

    * ``subject_block.spatial_attention.z`` (complex) → ``z_re``/``z_im``
    * ``subject_block.conv`` (1×1 Conv1d) → ``subject_block.conv`` (out, in)
    * ``subject_block.subject_layer.{s}.weight`` (bias-free 1×1 convs,
      (out, in, 1)) → one stacked ``subject_layer.weight`` (S, in, out)
    * ``conv_blocks.conv{k}.conv0/conv1`` → ``conv{k}.conv0/conv1``;
      ``...conv2`` (the 2·D2 GLU conv) → split into ``conv2a``/``conv2b``
    * ``...batchnorm0/1`` → ``bn0/1`` (``weight``/``bias`` → ``scale``/
      ``bias``, running mean/var → ``mean``/``var``)
    * ``conv_final1/2`` (1×1 convs) → ``conv_final1/2`` (out, in)
    """
    z = _t(sd["subject_block.spatial_attention.z"])
    S = len({k.split(".")[2] for k in sd
             if k.startswith("subject_block.subject_layer.")})
    out = {
        "subject_block.spatial_attention.z_re": _f32(torch.real(z)),
        "subject_block.spatial_attention.z_im": _f32(torch.imag(z)),
        "subject_block.conv.weight": _conv1x1(sd["subject_block.conv.weight"]),
        "subject_block.conv.bias": _f32(sd["subject_block.conv.bias"]),
        "subject_block.subject_layer.weight": torch.stack([
            _conv1x1(sd[f"subject_block.subject_layer.{s}.weight"]).T
            for s in range(S)]).contiguous(),
    }
    for k in range(num_blocks):
        ref = f"conv_blocks.conv{k}"
        for c in ("conv0", "conv1"):
            out[f"conv{k}.{c}.weight"] = _f32(sd[f"{ref}.{c}.weight"])
            out[f"conv{k}.{c}.bias"] = _f32(sd[f"{ref}.{c}.bias"])
        w2, b2 = _f32(sd[f"{ref}.conv2.weight"]), _f32(sd[f"{ref}.conv2.bias"])
        D2 = w2.shape[0] // 2
        out[f"conv{k}.conv2a.weight"] = w2[:D2].contiguous()
        out[f"conv{k}.conv2a.bias"] = b2[:D2].contiguous()
        out[f"conv{k}.conv2b.weight"] = w2[D2:].contiguous()
        out[f"conv{k}.conv2b.bias"] = b2[D2:].contiguous()
        for i in (0, 1):
            bn = f"{ref}.batchnorm{i}"
            out[f"conv{k}.bn{i}.scale"] = _f32(sd[f"{bn}.weight"])
            out[f"conv{k}.bn{i}.bias"] = _f32(sd[f"{bn}.bias"])
            out[f"conv{k}.bn{i}.mean"] = _f32(sd[f"{bn}.running_mean"])
            out[f"conv{k}.bn{i}.var"] = _f32(sd[f"{bn}.running_var"])
    for name in ("conv_final1", "conv_final2"):
        out[f"{name}.weight"] = _conv1x1(sd[f"{name}.weight"])
        out[f"{name}.bias"] = _f32(sd[f"{name}.bias"])
    return out


def eegnet_from_state_dict(sd: dict) -> dict:
    """Reference EEGNet (``models.py:32-94``) state_dict → the port's
    ``EEGNet`` state_dict.

    The reference wraps its stages in ``nn.Sequential``, so its keys are
    positional (``conv1.0`` = conv, ``conv1.1`` = BN; ``conv3.0/1/2`` =
    depthwise / pointwise / BN).  The port keeps the convolutions' OIHW
    layout.  The classifier: the reference flattens NCHW (index c·W' + w
    after the height collapses to 1), the port, as flax, NHWC (index
    w·C + c), so the classifier's columns are permuted and the imported
    head computes the same function."""
    out = {"conv1": _f32(sd["conv1.0.weight"]),
           "conv2": _f32(sd["conv2.0.weight"]),
           "conv3_dw": _f32(sd["conv3.0.weight"]),
           "conv3_pw": _f32(sd["conv3.1.weight"])}
    for name, ref in (("bn1", "conv1.1"), ("bn2", "conv2.1"), ("bn3", "conv3.2")):
        out[f"{name}.scale"] = _f32(sd[f"{ref}.weight"])
        out[f"{name}.bias"] = _f32(sd[f"{ref}.bias"])
        out[f"{name}.mean"] = _f32(sd[f"{ref}.running_mean"])
        out[f"{name}.var"] = _f32(sd[f"{ref}.running_var"])
    W = _f32(sd["classifier.weight"])            # (out, C·W') NCHW-flat
    F2 = out["conv3_pw"].shape[0]                # pointwise out = C
    out["classifier.weight"] = (W.reshape(W.shape[0], F2, -1).transpose(1, 2)
                                .reshape(W.shape[0], -1).contiguous())
    out["classifier.bias"] = _f32(sd["classifier.bias"])
    return out


def linear_encoder_from_state_dict(sd: dict) -> dict:
    """Reference LinearEncoder (``models.py:325-337``: one
    ``linear.weight/bias``) → the port's ``LinearEncoder`` state_dict."""
    return {"linear.weight": _f32(sd["linear.weight"]),
            "linear.bias": _f32(sd["linear.bias"])}
