"""Carry flax variables into the port's state_dict names.

The port keeps the flax parameter names wherever a name maps 1:1 (see
``models/layers.py``), so the conversion is a rename plus transpose:

* Dense kernel ``(in, out)`` → ``weight (out, in)``;
* Conv kernel ``(ks, in, out)`` → ``weight (out, in, ks)``;
* 2-D conv kernel, HWIO ``(kh, kw, in, out)`` → OIHW ``weight`` (EEGNet's
  convs keep their flax names, ``conv1`` … ``conv3_pw``, without a
  ``.weight`` suffix);
* EEGNetSub's bank ``conv1_sub`` ``(S, 1, k1, 1, F1)`` → ``(S, F1, 1, 1,
  k1)``, one OIHW kernel per subject;
* everything else (``z_re``/``z_im``, ``subject_layer.weight``, biases,
  BN ``scale``/``bias``) keeps its name and layout;
* ``batch_stats`` ``mean``/``var`` land in the BN buffers of the same name;
* a TrainState-style ``params = {'model': …, 'loss': {'temp': …}}`` keeps
  its temperature as ``'loss.temp'``;
* ``optax.adam``'s state: its ``ScaleByAdamState`` moments ``mu``/``nu``
  follow the parameters' names and layouts, ``count`` stays a scalar.

The stimulus encoders (``features/wav2vec2_model.py``,
``features/clip_model.py``) keep transformers' module trees, and take
weights from two sources:

* a Flax params tree (``encoder_params_from_flax``): Dense ``(in, out)`` →
  ``(out, in)``, Conv ``(K, in, out)`` → ``(out, in, K)``, the 2-D patch
  conv HWIO → OIHW, LayerNorm ``scale`` → ``weight``, ``nn.Embed``'s
  ``embedding`` → ``weight``; the weight-norm pair ``weight_v`` (out, in/g,
  K) and ``weight_g`` (1, 1, K) already has torch's layout;
* a transformers-torch ``state_dict`` (``encoder_params_from_hf``): the
  names are the port's, apart from a ``wav2vec2.`` prefix (checkpoints of
  the pre-training or CTC heads) and the weight norm's newer names
  ``parametrizations.weight.original0``/``original1`` (``weight_g`` /
  ``weight_v``).

Both keep only the entries the target module has (the CLIP text tower,
wav2vec2's quantizer) and raise when one of its entries is missing.

Input leaves are numpy arrays (``np.asarray`` each jax array first), so
this module needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from meg_decoding_tpu_torch.train.optim import AdamState

__all__ = ["params_from_jax", "adam_state_from_jax", "split_loss_params",
           "encoder_params_from_flax", "encoder_params_from_hf"]


def _flatten(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, key + ".")
        else:
            yield key, np.asarray(v)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _params_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """A flax params tree (or a TrainState's ``{'model', 'loss'}``, or a
    moment tree of the same structure) → the port's names and layouts."""
    loss = {}
    if "model" in params:  # TrainState layout
        loss = params.get("loss", {})
        params = params["model"]
    out = {}
    for key, a in _flatten(params):
        if key.endswith(".kernel"):
            if a.ndim == 4:  # HWIO → OIHW, a bare parameter in the port
                key, a = key[: -len(".kernel")], np.transpose(a, (3, 2, 0, 1))
            else:
                key = key[: -len("kernel")] + "weight"
                a = a.T if a.ndim == 2 else np.transpose(a, (2, 1, 0))
        elif key == "conv1_sub":
            a = np.transpose(a, (0, 4, 3, 1, 2))
        out[key] = _tensor(a)
    for key, a in _flatten(loss, "loss."):
        out[key] = _tensor(a)
    return out


def params_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{'params', 'batch_stats'}`` tree of numpy arrays → state_dict."""
    out = _params_state_dict(variables["params"])
    for key, a in _flatten(variables.get("batch_stats", {})):
        out[key] = _tensor(a)
    return out


def adam_state_from_jax(opt_state) -> AdamState:
    """``optax.adam``'s state (the chain's tuple, numpy leaves) → the port's
    ``AdamState``, its moments keyed like ``params_from_jax``."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    return AdamState(mu=_params_state_dict(adam.mu),
                     nu=_params_state_dict(adam.nu),
                     count=_tensor(np.asarray(adam.count)))


def split_loss_params(state_dict: Mapping) -> tuple[dict, dict]:
    """(model entries, ``loss.*`` entries with the prefix removed)."""
    model = {k: v for k, v in state_dict.items() if not k.startswith("loss.")}
    loss = {k[len("loss."):]: v for k, v in state_dict.items()
            if k.startswith("loss.")}
    return model, loss


def _for_module(entries: dict, module: torch.nn.Module, source: str) -> dict:
    """The entries ``module`` has; raises when one of its entries is missing."""
    want = module.state_dict().keys()
    missing = sorted(set(want) - entries.keys())
    if missing:
        raise KeyError(f"{source} lacks {len(missing)} entries of "
                       f"{type(module).__name__}: {missing[:5]}")
    return {k: entries[k] for k in want}


_FLAX_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def encoder_params_from_flax(params: Mapping, module: torch.nn.Module
                             ) -> dict[str, torch.Tensor]:
    """A transformers Flax params tree (numpy leaves) → ``module``'s
    state_dict (a ``Wav2Vec2Model`` or a ``CLIPImageEncoder``)."""
    out = {}
    for key, a in _flatten(params):
        stem, _, leaf = key.rpartition(".")
        if leaf == "kernel":
            key, a = f"{stem}.weight", np.transpose(a, _FLAX_KERNEL_AXES[a.ndim])
        elif leaf in ("scale", "embedding"):
            key = f"{stem}.weight"
        out[key] = _tensor(a)
    return _for_module(out, module, "the Flax params")


_HF_RENAMES = (("parametrizations.weight.original0", "weight_g"),
               ("parametrizations.weight.original1", "weight_v"))


def encoder_params_from_hf(state_dict: Mapping, module: torch.nn.Module
                           ) -> dict[str, torch.Tensor]:
    """A transformers-torch state_dict → ``module``'s state_dict."""
    out = {}
    for key, t in state_dict.items():
        key = key.removeprefix("wav2vec2.")
        for old, new in _HF_RENAMES:
            key = key.replace(old, new)
        out[key] = t
    return _for_module(out, module, "the checkpoint")
