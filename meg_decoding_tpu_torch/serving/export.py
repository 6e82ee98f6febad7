"""Serving artifacts through ``torch.export``.  Port of
``meg_decoding_tpu/serving/export.py``.

An artifact is a directory that a serving host loads without the model's
code:

* ``forward.pt2`` — the ``torch.export`` program: raw MEG windows
  ``(B, C, T)`` f32 and subject ids ``(B,)`` int32 → embeddings.  The batch
  size is symbolic (``torch.export.Dim`` on B of both inputs), so one
  program serves any request size.  The program holds the whole serving
  pipeline: the collate chain (baseline correction → RobustScaler → clamp,
  ``ops/scaling.py``) and the encoder's eval-mode forward.  Its percentiles
  are the hand-written kernel, reached through the registered custom op
  ``meg_decoding_tpu_torch::robust_quantiles``
  (``ops/kernels/quantile.py``): the op's CUDA kernel runs on the card, its
  CPU kernel (the plain version) on the CPU.  (The JAX artifact exports the
  portable sort instead, to keep a Pallas custom call out of its format.)
* ``weights.pt`` — the encoder's state_dict (``torch.save``; loaded with
  ``weights_only=True``).  The weights are call-time arguments of the
  program, never constants of it: the program is a functional forward
  (``torch.func.functional_call``), so its file holds no copy of them and
  a new set of weights needs no new export.
* ``meta.json`` — input shapes and dtypes, the collate's parameters, the
  model's class, the custom ops the program calls: enough for a serving
  host to validate requests without importing this package.

``load_artifact`` imports ``ops/kernels/quantile.py`` (which registers the
op) before it loads the program, and moves program and weights to the
device asked for.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn as nn

from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.ops.kernels.quantile import OP_NAME
from meg_decoding_tpu_torch.ops.scaling import collate_preprocess

__all__ = ["make_serving_forward", "export_serving", "save_artifact",
           "load_artifact", "ServingModel", "ARTIFACT_PROGRAM",
           "ARTIFACT_WEIGHTS", "ARTIFACT_META"]

ARTIFACT_PROGRAM = "forward.pt2"
ARTIFACT_WEIGHTS = "weights.pt"
ARTIFACT_META = "meta.json"
PLATFORMS = ("cuda", "cpu")
# a symbolic batch of 1 traces as 0/1-specialised; trace at this size
_EXAMPLE_BATCH = 2


def _package_version() -> str:
    import meg_decoding_tpu_torch

    return getattr(meg_decoding_tpu_torch, "__version__", "unknown")


def _collate_enabled(collate_cfg) -> bool:
    return bool(collate_cfg is not None and getattr(collate_cfg, "enabled", True))


def make_serving_forward(collate_cfg=None):
    """Returns ``forward(model, X, subject_idxs) -> Z``: the collate chain
    (when ``collate_cfg`` is given and enabled) and the eval-mode encoder
    (the JAX forward's ``variables`` argument is the module here).  X:
    (B, C, T) raw windows on the model's device."""
    enabled = _collate_enabled(collate_cfg)

    @torch.no_grad()
    def forward(model, X, subject_idxs):
        model.eval()
        if enabled:
            X = collate_preprocess(X, collate_cfg.baseline_len_samp,
                                   collate_cfg.clamp_lim, collate_cfg.clamp)
        return model(X, subject_idxs)

    return forward


class _FunctionalForward(nn.Module):
    """``(weights, X, subject_idxs) -> Z`` over a model it does not own as a
    submodule, so ``torch.export`` lifts none of the model's parameters
    into the program: the weights come in as the first argument."""

    def __init__(self, model: nn.Module, collate_cfg):
        super().__init__()
        object.__setattr__(self, "_model", model)
        self.collate_cfg = collate_cfg if _collate_enabled(collate_cfg) else None

    def forward(self, weights: dict, X: torch.Tensor,
                subject_idxs: torch.Tensor) -> torch.Tensor:
        c = self.collate_cfg
        if c is not None:
            X = collate_preprocess(X, c.baseline_len_samp, c.clamp_lim,
                                   c.clamp)
        return torch.func.functional_call(self._model, weights,
                                          (X, subject_idxs))


def _prune_noop_casts(program: torch.export.ExportedProgram) -> None:
    """Remove, in place, the casts to the dtype a tensor already has and the
    dtype assertions export puts before every cast (~90 each in the brain
    encoder): each is a dispatcher call a request, ~2 ms of host time per
    request on the card together, and none changes a value.  The inputs'
    dtypes are fixed where ``ServingModel`` casts X and the subject ids and
    checks the weights (``_Weights``)."""
    graph = program.graph
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and node.args[0].meta["val"].dtype == node.args[1]
              and all(u.op != "output" for u in node.users)):  # named outputs
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    program.graph_module.recompile()


def export_serving(model: nn.Module, num_channels: int, seq_len: int,
                   collate_cfg=None) -> torch.export.ExportedProgram:
    """The serving forward of ``model`` (eval mode) as a batch-polymorphic
    ``torch.export`` program on the model's device, taking
    ``(weights, X, subject_idxs)`` with ``weights`` = ``model.state_dict()``
    (only their shapes matter here)."""
    model.eval()
    dev = next(model.parameters()).device
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    X = torch.zeros((_EXAMPLE_BATCH, int(num_channels), int(seq_len)),
                    dtype=torch.float32, device=dev)
    subs = torch.zeros((_EXAMPLE_BATCH,), dtype=torch.int32, device=dev)
    batch = torch.export.Dim("batch", min=1)
    dynamic = ({k: None for k in weights}, {0: batch}, {0: batch})
    with torch.no_grad():
        program = torch.export.export(_FunctionalForward(model, collate_cfg),
                                      (weights, X, subs),
                                      dynamic_shapes=dynamic, strict=False)
    _prune_noop_casts(program)
    return program


def save_artifact(out_dir: str, model: nn.Module, num_channels: int,
                  seq_len: int, collate_cfg=None,
                  extra_meta: dict | None = None) -> str:
    """Export ``model`` and write the three artifact files; returns
    ``out_dir``."""
    program = export_serving(model, num_channels, seq_len, collate_cfg)
    # the program keeps its example inputs, the weights among them, for
    # torch.export.save to write; the artifact holds the weights once
    program.example_inputs = None
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, ARTIFACT_PROGRAM))
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, ARTIFACT_WEIGHTS))
    meta = {
        "input": {"X": [None, int(num_channels), int(seq_len)],
                  "X_dtype": "float32",
                  "subject_idxs": [None], "subject_idxs_dtype": "int32"},
        "platforms": list(PLATFORMS),
        "custom_ops": [OP_NAME] if _collate_enabled(collate_cfg) else [],
        "collate": None if collate_cfg is None else {
            "enabled": _collate_enabled(collate_cfg),
            "baseline_len_samp": int(collate_cfg.baseline_len_samp),
            "clamp_lim": float(collate_cfg.clamp_lim),
            "clamp": bool(collate_cfg.clamp),
        },
        "model": type(model).__name__,
        "framework_version": _package_version(),
    }
    meta.update(extra_meta or {})
    with open(os.path.join(out_dir, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=2)
    return out_dir


def _weight_specs(program: torch.export.ExportedProgram) -> dict:
    """Name → (shape, dtype) of each weight the program takes, read from
    its input placeholders."""
    from torch.utils._pytree import tree_unflatten

    (weights, _, _), _ = tree_unflatten(
        list(program.graph_signature.user_inputs), program.call_spec.in_spec)
    vals = {n.name: n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder"}
    return {k: (tuple(vals[n].shape), vals[n].dtype) for k, n in weights.items()}


class _Weights(dict):
    """The weights a program takes: every entry set is checked against the
    program's input of that name (shape, dtype), since the program itself
    no longer checks dtypes (``_prune_noop_casts``)."""

    def __init__(self, specs: dict, weights: dict):
        super().__init__()
        self._specs = specs
        if set(weights) != set(specs):
            raise ValueError(f"weights {sorted(set(weights) ^ set(specs))}: "
                             "not the program's names")
        for k in specs:  # the program's order
            self[k] = weights[k]

    def __setitem__(self, name: str, w: torch.Tensor) -> None:
        if name not in self._specs:
            raise KeyError(f"the program takes no weight {name!r}")
        shape, dtype = self._specs[name]
        if tuple(w.shape) != shape or w.dtype != dtype:
            raise ValueError(f"weights[{name!r}]: {tuple(w.shape)} {w.dtype}, "
                             f"the program takes {shape} {dtype}")
        super().__setitem__(name, w)

    def update(self, other=(), **kw) -> None:
        for k, v in dict(other, **kw).items():
            self[k] = v


class ServingModel:
    """A loaded artifact: ``__call__(X, subject_idxs) -> Z`` on its device.
    ``weights`` is the state_dict the program takes (a dict of tensors on
    the device, checked against the program's inputs as it or an entry is
    set): replacing or scaling an entry changes what it serves."""

    def __init__(self, program: torch.export.ExportedProgram, weights: dict,
                 meta: dict, device: torch.device):
        self.program = program
        self._specs = _weight_specs(program)
        self.weights = weights
        self.meta = meta
        self.device = device
        self._module = program.module()

    @property
    def weights(self) -> dict:
        return self._weights

    @weights.setter
    def weights(self, weights: dict) -> None:
        self._weights = _Weights(self._specs, weights)

    @property
    def platforms(self) -> tuple:
        return tuple(self.meta["platforms"])

    @torch.no_grad()
    def __call__(self, X, subject_idxs) -> torch.Tensor:
        X = torch.as_tensor(X).to(device=self.device, dtype=torch.float32)
        subs = torch.as_tensor(subject_idxs).to(device=self.device,
                                                dtype=torch.int32)
        # a plain dict: the program's input spec is a dict's
        return self._module(dict(self.weights), X, subs)


def load_artifact(out_dir: str, device: str | torch.device = "cuda"
                  ) -> ServingModel:
    """Load a serving artifact onto ``device`` (``"cuda"`` by default; pass
    ``"cpu"`` explicitly) — no model code needed: the program is the
    model."""
    import meg_decoding_tpu_torch.ops.kernels.quantile  # noqa: F401  registers the op
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    program = torch.export.load(os.path.join(out_dir, ARTIFACT_PROGRAM))
    program = move_to_device_pass(program, dev)
    weights = torch.load(os.path.join(out_dir, ARTIFACT_WEIGHTS),
                         map_location=dev, weights_only=True)
    with open(os.path.join(out_dir, ARTIFACT_META)) as f:
        meta = json.load(f)
    return ServingModel(program, weights, meta, dev)
