"""Sensor geometry: 2-D channel locations for spatial attention.

Port of ``meg_decoding_tpu/data/layout.py``.  Resolution order:

1. ``cfg.layout_csv`` — explicit CSV of per-channel coordinates (2 or 3
   cols), filtered to ``roi_channels`` when given.
2. GOD — ``cfg.montage_path`` CSV (the reference's ``montage.csv``: first
   two of three coordinates, reference ``layout.py:34-36``) filtered to the
   ROI channels; falls back to the port's packaged copy of the Ricoh
   montage (``data/layouts/god_montage.csv``).
3. Brennan — the port's packaged easycap-M10 coordinates
   (``data/layouts/easycap_M10.csv``, the JAX package's file: a geometric
   reconstruction of the 61-electrode equidistant montage, projected like
   MNE's ``find_layout``), minus broken channel 29 (reference
   ``layout.py:16-18``) for 60 channels; any other channel count gets a
   synthetic cap.
4. Gwilliams — the cache-resident ``layout.npy`` the cache builder extracts
   from the first BIDS recording (``cfg.cache_dir``); otherwise a
   deterministic synthetic cap layout (Vogel spiral over the scalp disc),
   structure-preserving only.

Locations are min-max normalized into ``[0.1, 0.9]`` (reference
``layout.py:42-45``).  Numpy only.
"""

from __future__ import annotations

import csv
import os
import warnings

import numpy as np

from meg_decoding_tpu_torch.data.roi import LAYOUTS_DIR, roi

__all__ = ["ch_locations_2d", "easycap_m10_locations", "normalize_locations",
           "synthetic_cap_locations"]


def normalize_locations(loc: np.ndarray) -> np.ndarray:
    """Min-max normalize each axis then rescale into [0.1, 0.9] (the Fourier
    attention basis is periodic, so keep a margin of 0.1 on each side)."""
    loc = np.asarray(loc, dtype=np.float32)
    loc = (loc - loc.min(axis=0)) / (loc.max(axis=0) - loc.min(axis=0))
    return (loc * 0.8 + 0.1).astype(np.float32)


def synthetic_cap_locations(num_channels: int, seed: int = 0) -> np.ndarray:
    """Deterministic concentric-ring layout on the unit disc (cap-like)."""
    # sunflower (Vogel) spiral: uniform over the disc, no two points coincide
    idx = np.arange(num_channels, dtype=np.float64) + 0.5
    r = np.sqrt(idx / num_channels)
    theta = idx * (np.pi * (3.0 - np.sqrt(5.0)))
    loc = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
    return loc.astype(np.float32)


def _read_csv_coords(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row:
                continue
            rows.append([float(v) for v in row])
    return np.asarray(rows, dtype=np.float32)


def easycap_m10_locations() -> np.ndarray:
    """The packaged (61, 2) easycap-M10 coordinates."""
    return _read_csv_coords(os.path.join(LAYOUTS_DIR, "easycap_M10.csv"))


def ch_locations_2d(cfg, roi_channels: list[int] | None = None) -> np.ndarray:
    """Resolve normalized (C, 2) sensor coordinates for ``cfg.dataset``;
    ``roi_channels`` selects rows of an explicit CSV or of the GOD montage
    (GOD defaults to ``roi(cfg)``)."""
    explicit = cfg.get("layout_csv")
    if explicit:
        loc = _read_csv_coords(explicit)[:, :2]
        if roi_channels is not None:
            loc = loc[np.asarray(roi_channels)]
        return normalize_locations(loc)

    if cfg.dataset == "GOD":
        montage_path = cfg.get("montage_path")
        if not (montage_path and os.path.exists(montage_path)):
            montage_path = os.path.join(LAYOUTS_DIR, "god_montage.csv")
        if roi_channels is None:
            roi_channels = roi(cfg)
        montage = _read_csv_coords(montage_path)  # (C, 3)
        return normalize_locations(montage[np.asarray(roi_channels), :2])

    if cfg.dataset == "Brennan2018":
        num = int(cfg.get("num_channels", 60) or 60)
        if num in (60, 61):
            loc = easycap_m10_locations()
            if num == 60:
                loc = np.delete(loc, 28, axis=0)
        else:
            warnings.warn(
                f"Brennan layout requested for {num} channels — the easycap "
                "M10 montage has 61; using a synthetic cap (accuracy parity "
                "needs real geometry)")
            loc = synthetic_cap_locations(num)
        return normalize_locations(loc)

    if cfg.dataset != "Gwilliams2022":
        raise NotImplementedError(
            f"no layout for dataset {cfg.dataset!r} (Gwilliams2022, "
            "Brennan2018, GOD or an explicit layout_csv)")
    num = int(cfg.get("num_channels", 208) or 208)
    cache_dir = cfg.get("cache_dir")
    layout_path = cache_dir and os.path.join(cache_dir, "layout.npy")
    if layout_path and os.path.exists(layout_path):
        loc = np.asarray(np.load(layout_path), dtype=np.float32)[:, :2]
        if loc.shape[0] >= num:
            return normalize_locations(loc[:num])
        warnings.warn(
            f"cache layout.npy has {loc.shape[0]} channels but the data "
            f"has {num} — falling back to a synthetic cap")
    else:
        warnings.warn(
            "no cache-resident Gwilliams sensor layout (layout.npy) — "
            "using a synthetic cap.  SpatialAttention needs the real "
            "geometry for accuracy parity; point cfg.layout_csv at "
            "coordinates or rebuild the cache with its layout.")
    return normalize_locations(synthetic_cap_locations(num))
