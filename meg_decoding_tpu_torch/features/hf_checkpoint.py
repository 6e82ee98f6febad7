"""Local Hugging Face checkpoints, read without transformers.

A checkpoint is a directory holding ``config.json`` and the weights, as
``model.safetensors``, safetensors shards listed in
``model.safetensors.index.json`` (DeepSeek-V2-Lite's four), or
``pytorch_model.bin``.  ``checkpoint_dir``
accepts such a directory, or a hub id (``org/name``) already in the hub
cache (``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``: ``models--org--name/snapshots/<rev>/``).
Nothing is downloaded.

The safetensors format is parsed here: an 8-byte little-endian header
length, a JSON header mapping each name to its dtype, shape and byte
range, then the raw little-endian tensors.  ``pytorch_model.bin`` goes
through ``torch.load(weights_only=True)``.

``load_encoder`` is the backend choice of ``features/wav2vec.py:
load_wav2vec``, ``features/clip_features.py:load_clip`` and
``features/text_llm.py:load_text_llm``: ``hf`` (such a
checkpoint), ``random`` (seeded weights drawn on the device), ``auto``
(``hf``, else ``random`` with a loud message, as the JAX package does).
"""

from __future__ import annotations

import glob
import json
import os
import struct

import torch

from meg_decoding_tpu_torch.interop import _for_module, encoder_params_from_hf

__all__ = ["checkpoint_dir", "read_config", "read_state_dict",
           "read_safetensors", "load_encoder", "deepseek_v2_params_from_hf"]

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _hub_cache() -> str:
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(home, "hub")


def checkpoint_dir(name: str) -> str:
    """The local directory of checkpoint ``name`` (a path, or a hub id in
    the hub cache); raises FileNotFoundError when there is none."""
    if os.path.isdir(name):
        if not os.path.exists(os.path.join(name, "config.json")):
            raise FileNotFoundError(f"{name} holds no config.json")
        return name
    repo = os.path.join(_hub_cache(), "models--" + name.replace("/", "--"))
    ref = os.path.join(repo, "refs", "main")
    snapshots = []
    if os.path.exists(ref):
        with open(ref) as f:
            snapshots.append(os.path.join(repo, "snapshots", f.read().strip()))
    snapshots += sorted(glob.glob(os.path.join(repo, "snapshots", "*")))
    for snap in snapshots:
        if os.path.exists(os.path.join(snap, "config.json")):
            return snap
    raise FileNotFoundError(
        f"no local checkpoint {name!r}: neither a directory nor in the hub "
        f"cache under {_hub_cache()}")


def read_config(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        return json.load(f)


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        count = (end - begin) // dtype.itemsize
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=begin)
        out[name] = t.reshape(entry["shape"])
    return out


def read_state_dict(ckpt_dir: str) -> dict[str, torch.Tensor]:
    """The checkpoint's weights: ``model.safetensors`` if present, else the
    shards that ``model.safetensors.index.json`` lists, else
    ``pytorch_model.bin``."""
    st = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(st):
        return read_safetensors(st)
    index = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(ckpt_dir, shard)))
        return out
    binary = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(binary):
        return torch.load(binary, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"{ckpt_dir} holds neither model.safetensors nor pytorch_model.bin")


def deepseek_v2_params_from_hf(state_dict, module: torch.nn.Module) -> dict:
    """A ``DeepseekV2ForCausalLM`` (or ``DeepseekV2Model``) state_dict →
    ``module``'s (``features/deepseek_v2_model.py``, transformers' names
    under ``model.``): the prefix dropped, and the LM head and any rotary
    ``inv_freq`` buffer left out (the features are hidden states).  The
    same for ``KimiLinearForCausalLM`` (``features/kimi_linear_model.py``),
    whose routed experts not held by the module are left out with every
    other entry it does not have."""
    out = {}
    for key, t in state_dict.items():
        key = key.removeprefix("model.")
        if key == "lm_head.weight" or key.endswith("rotary_emb.inv_freq"):
            continue
        out[key] = t
    return _for_module(out, module, "the checkpoint")


def load_encoder(model_name: str, backend: str, build, config_from_dict,
                 init_random, what: str,
                 from_hf=encoder_params_from_hf) -> torch.nn.Module:
    """The encoder per ``backend``, in eval mode without gradients.
    ``build(config)`` makes the module on its device, ``config_from_dict``
    reads a ``config.json``, ``init_random(module)`` draws its weights,
    ``from_hf(state_dict, module)`` renames a checkpoint's weights;
    ``build()`` with no argument is the random backend's architecture."""
    if backend not in ("hf", "random", "auto"):
        raise ValueError(f"unknown {what} backend {backend!r} (hf, random, auto)")
    model = None
    if backend != "random":
        try:
            ckpt = checkpoint_dir(model_name)
            model = build(config_from_dict(read_config(ckpt)))
            model.load_state_dict(from_hf(read_state_dict(ckpt), model))
        except (OSError, KeyError, ValueError, NotImplementedError) as e:
            if backend == "hf":
                raise
            model = None
            print(f"[{what}] WARNING: weights of {model_name!r} unavailable "
                  f"({type(e).__name__}: {e}); using a RANDOMLY INITIALIZED "
                  "model (backend='random') — its features carry no "
                  "information from the stimulus", flush=True)
    if model is None:
        model = init_random(build())
    return model.eval().requires_grad_(False)
