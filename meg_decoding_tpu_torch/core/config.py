"""Hydra-compatible YAML configuration.

The reference drives every entry point through Hydra/OmegaConf
(``train.py:28``, ``train_wowandb_cv.py:360-363`` in the reference repo).
Hydra is not available in this image, so this module provides the small
subset the framework needs, with the same user-facing semantics:

* ``Config`` — attribute *and* item access over nested dicts (DictConfig-like),
  with ``in`` / ``.get`` / ``.keys`` support and mutation.
* ``compose(config_path, config_name, overrides)`` — loads a YAML, resolves a
  Hydra ``defaults:`` list (relative group paths, ``_self_`` ordering), applies
  dotted CLI-style overrides (``a.b.c=value``, values parsed as YAML, ``+key=``
  to add new keys), and resolves ``${a.b}`` interpolations.

Config YAMLs under ``configs/`` stay drop-in compatible with the reference's
(`configs/config.yaml`, `configs/config_GOD.yaml`).

The port's own copy of ``meg_decoding_tpu/core/config.py`` (which imports no
JAX): the port reads the same YAMLs and never imports the JAX package.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Iterator, Mapping

import yaml

__all__ = ["Config", "load_yaml", "compose", "to_dict", "merge"]

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(Mapping):
    """Nested attribute/item-access view over a dict (OmegaConf-like)."""

    def __init__(self, data: dict | None = None):
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _wrap(v)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __delitem__(self, key: str) -> None:
        del self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def values(self):
        return self._data.values()

    def items(self):
        return self._data.items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._data.get(key, default)

    # -- attribute protocol -------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _wrap(value)

    def __delattr__(self, key: str) -> None:
        del self._data[key]

    # -- utilities ----------------------------------------------------------
    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(to_dict(self), memo))

    def select(self, dotted: str, default: Any = None) -> Any:
        """``cfg.select('a.b.c')`` → value or default."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, dict):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def to_dict(node: Any) -> Any:
    """Recursively convert a Config tree back to plain python containers."""
    if isinstance(node, Config):
        return {k: to_dict(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_dict(v) for v in node]
    return node


def merge(base: Config, override: Config) -> Config:
    """Deep merge: override wins; nested Configs merge recursively."""
    out = Config(to_dict(base))
    for k, v in override.items():
        if k in out and isinstance(out[k], Config) and isinstance(v, Config):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(to_dict(v)) if isinstance(v, Config) else v
    return out


def load_yaml(path: str | Path) -> Config:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def _resolve_defaults(config_dir: Path, cfg: Config) -> Config:
    """Resolve a Hydra ``defaults:`` list (group/name entries + ``_self_``)."""
    defaults = cfg.get("defaults")
    if defaults is None:
        return cfg
    del cfg["defaults"]
    merged = Config()
    self_seen = False
    for entry in defaults:
        if entry == "_self_":
            merged = merge(merged, cfg)
            self_seen = True
            continue
        if isinstance(entry, Config):
            # {group: name} form
            ((group, name),) = entry.items()
            sub_path = config_dir / group / f"{name}.yaml"
        else:
            sub_path = config_dir / f"{entry}.yaml"
        sub = load_yaml(sub_path)
        sub = _resolve_defaults(sub_path.parent, sub)
        merged = merge(merged, sub)
    if not self_seen:
        merged = merge(merged, cfg)
    return merged


def _interpolate(root: Config, node: Any) -> Any:
    if isinstance(node, Config):
        for k in list(node.keys()):
            node[k] = _interpolate(root, node[k])
        return node
    if isinstance(node, list):
        return [_interpolate(root, v) for v in node]
    if isinstance(node, str):
        m = _INTERP_RE.fullmatch(node)
        if m:  # whole-string interpolation keeps the referenced type
            return root.select(m.group(1))
        return _INTERP_RE.sub(lambda m: str(root.select(m.group(1))), node)
    return node


def compose(
    config_path: str | Path,
    config_name: str,
    overrides: list[str] | None = None,
) -> Config:
    """Hydra-style composition: YAML + defaults list + CLI overrides."""
    config_dir = Path(config_path)
    name = config_name if config_name.endswith(".yaml") else config_name + ".yaml"
    cfg = load_yaml(config_dir / name)
    cfg = _resolve_defaults(config_dir, cfg)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must look like key=value")
        key, _, raw = ov.partition("=")
        key = key.lstrip("+")  # '+key=value' adds a new key; we always allow
        cfg.set_dotted(key, yaml.safe_load(raw) if raw != "" else None)
    cfg = _interpolate(cfg, cfg)
    return cfg
