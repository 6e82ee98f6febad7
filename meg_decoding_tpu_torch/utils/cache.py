"""Preprocessing cache: settings-matched numbered directories.  Port of
``meg_decoding_tpu/utils/cache.py`` (pure Python, copied: the port imports
nothing of the JAX package); the directory layout and the numbering rule
are the same, so caches built by either package interoperate.

Reference: ``meg_decoding/utils/preproc_utils.py:13-66`` (``check_preprocs``)
— probes ``<data_dir>/<n>/settings.json`` for a directory whose recorded
preproc params match the current config (ignoring excluded keys), otherwise
allocates a new numbered directory and writes settings.json with
``x_done``/``y_done`` progress flags.  Same directory layout here (caches
interoperate), plus a content-hash shortcut for programmatic use.
"""

from __future__ import annotations

import hashlib
import json
import os

__all__ = ["check_preprocs", "config_hash", "mark_done", "is_done"]

_EXCLUDED_KEYS = ("preceding_chunk_for_baseline", "mode")


def config_hash(params: dict) -> str:
    canon = json.dumps(
        {k: v for k, v in sorted(params.items()) if k not in _EXCLUDED_KEYS},
        sort_keys=True, default=str,
    )
    return hashlib.sha256(canon.encode()).hexdigest()[:16]


def check_preprocs(preproc_params: dict, data_dir: str) -> tuple[str, bool, bool]:
    """Find-or-create the cache dir matching ``preproc_params``.

    Returns (cache_dir, x_done, y_done).  Matching ignores the progress flags
    and the reference's excluded keys.
    """
    os.makedirs(data_dir, exist_ok=True)
    want = {k: v for k, v in preproc_params.items()
            if k not in _EXCLUDED_KEYS + ("x_done", "y_done")}
    existing = sorted(
        d for d in os.listdir(data_dir) if os.path.isdir(os.path.join(data_dir, d))
    )
    for name in existing:
        settings_path = os.path.join(data_dir, name, "settings.json")
        if not os.path.exists(settings_path):
            continue
        with open(settings_path) as f:
            settings = json.load(f)
        x_done = settings.pop("x_done", False)
        y_done = settings.pop("y_done", False)
        recorded = {k: v for k, v in settings.items() if k not in _EXCLUDED_KEYS}
        if recorded == want:
            return os.path.join(data_dir, name), x_done, y_done

    # first unused number — len(existing) would collide with a surviving
    # cache when the numbering has holes (e.g. '0' and '2' exist after a
    # manual delete of '1') and silently clobber its settings.json
    n = 0
    while os.path.exists(os.path.join(data_dir, str(n))):
        n += 1
    new_dir = os.path.join(data_dir, str(n))
    os.makedirs(new_dir, exist_ok=True)
    with open(os.path.join(new_dir, "settings.json"), "w") as f:
        json.dump({**want, "x_done": False, "y_done": False}, f)
    return new_dir, False, False


def mark_done(cache_dir: str, which: str) -> None:
    """Record x_done / y_done progress (reference gwilliams2022.py:84-107)."""
    path = os.path.join(cache_dir, "settings.json")
    with open(path) as f:
        settings = json.load(f)
    settings[which] = True
    with open(path, "w") as f:
        json.dump(settings, f)


def is_done(cache_dir: str, which: str) -> bool:
    path = os.path.join(cache_dir, "settings.json")
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return bool(json.load(f).get(which, False))
