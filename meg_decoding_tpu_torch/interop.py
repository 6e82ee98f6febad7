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

Input leaves are numpy arrays (``np.asarray`` each jax array first), so
this module needs no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from meg_decoding_tpu_torch.train.optim import AdamState

__all__ = ["params_from_jax", "adam_state_from_jax", "split_loss_params"]


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
