"""ROI (region-of-interest) channel selection for the GOD MEG dataset.
Port of ``meg_decoding_tpu/data/roi.py``.

Reference: ``meg_decoding/matlab_utils/load_meg.py:105-120`` — maps region
strings like ``"occipital/left"`` to channel indices via a JSON file of
region → sub-region → 1-indexed channel lists, converting to 0-indexed.
"""

from __future__ import annotations

import json
import os

__all__ = ["roi"]

LAYOUTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "layouts")


def roi(cfg, region=None) -> list[int]:
    """Resolve ``cfg.region`` strings to 0-indexed channel indices.

    ``region`` overrides ``cfg.region`` without mutating the config (the
    per-region-onset epoching resolves one region at a time).  Falls back
    to the port's packaged region table (``data/layouts/god_ch_region.json``,
    the reference's ``data/GOD/ch_region.json``) when ``cfg.ch_region_path``
    is absent or missing on disk."""
    path = cfg.get("ch_region_path")
    if not (path and os.path.exists(path)):
        path = os.path.join(LAYOUTS_DIR, "god_ch_region.json")
    with open(path) as f:
        ch_region_info = json.load(f)
    roi_channels: list[int] = []
    for reg in (cfg.region if region is None else region):
        parts = reg.split("/")
        if len(parts) != 2:
            raise ValueError(f"region must be 'region/subregion', got {reg!r}")
        name, sub = parts
        roi_channels += ch_region_info[name][sub]
    # the JSON stores MATLAB-style 1-indexed channels
    return [r - 1 for r in roi_channels]
