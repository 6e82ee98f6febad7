"""The hand-written CUDA kernels and their launch counters.

Each kernel wrapper counts its launches in module globals (an int, or a
dict of ints by kernel or route) and resets them in its
``reset_launches()``.  ``_COUNTERS`` lists every one of them, so that
callers read, credit and reset the counters without knowing which
kernels exist: ``train/graph.py`` credits a replay with what its capture
recorded (a replay runs no wrapper's Python), and the benchmark and
``chip_smoke.py`` read them.
"""

from __future__ import annotations

from meg_decoding_tpu_torch.ops.kernels import (
    adam,
    batchnorm,
    gelu,
    kda,
    moe,
    quantile,
    window_gather,
)

__all__ = ["launch_counts", "add_counts", "reset_launches"]

# the kernels' launch counters: (module, attribute), each an int or a dict
# of ints
_COUNTERS = ((window_gather, "launches"), (quantile, "launches"),
             (quantile, "long_launches"), (batchnorm, "launches"),
             (batchnorm, "stats_route_launches"),
             (batchnorm, "bwd_route_launches"),
             (batchnorm, "sums_only_launches"), (batchnorm, "dx_launches"),
             (gelu, "launches"), (moe, "launches"), (adam, "launches"),
             (kda, "launches"))


def launch_counts() -> dict:
    """Every kernel launch counter, by (module name, attribute, key or
    None)."""
    out = {}
    for mod, attr in _COUNTERS:
        name, v = mod.__name__.rsplit(".", 1)[1], getattr(mod, attr)
        if isinstance(v, dict):
            out.update({(name, attr, k): n for k, n in v.items()})
        else:
            out[(name, attr, None)] = v
    return out


def add_counts(delta: dict) -> None:
    """Add ``delta`` (keyed as ``launch_counts``) to the counters."""
    mods = {mod.__name__.rsplit(".", 1)[1]: mod for mod, _ in _COUNTERS}
    for (name, attr, key), n in delta.items():
        if n == 0:
            continue
        m = mods[name]
        if key is None:
            setattr(m, attr, getattr(m, attr) + n)
        else:
            getattr(m, attr)[key] += n


def reset_launches() -> None:
    """Zero every kernel's launch counters."""
    for mod in dict.fromkeys(mod for mod, _ in _COUNTERS):
        mod.reset_launches()
