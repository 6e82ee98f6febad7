"""GOD (Generic Object Decoding) MEG→image dataset builder.
Port of ``meg_decoding_tpu/data/god.py``.

Reference: ``meg_decoding/dataclass/god.py`` (``GODDatasetBase``) +
``meg_decoding/matlab_utils/load_meg.py`` (``get_meg_data``,
``get_baseline``, ``roi``, ``time_window``).

Per (subject, session): load the Brainstorm-exported ``.mat`` triples on
the host (MEG ``F``, label file with CLIP ``vec_image``/``vec_index``,
trigger onsets) → optional rest-period z-scoring in float64 → ROI channel
selection → on the device: bandpass (``ops/fir.py``) and resample
(``ops/resample.py``) of all ROI channels at once, then the trigger-based
epochs as one ``window_gather`` (``ops/scaling.py:epoch_slice``).  The
epochs come back to the host, where the optional global normalization
(reusable statistics, ``god.py:44-65``) and the ``val`` split's averaging
of epochs sharing (image, subject) (``god.py:154-167``) run in numpy as in
the JAX package, so both packages build the same dataset before the
device steps.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import torch

from meg_decoding_tpu_torch.data.packed import PackedDataset
from meg_decoding_tpu_torch.data.roi import roi
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.ops.fir import bandpass_filter
from meg_decoding_tpu_torch.ops.resample import resample_fft
from meg_decoding_tpu_torch.ops.scaling import epoch_slice

__all__ = ["get_baseline", "get_meg_data", "time_window", "build_god_dataset"]

_SPLIT_SIZES = {"train": 600, "test": 50, "rest": 60}


def get_baseline(meg_filepath: str, fs: float, duration: float):
    """Rest-period per-channel mean/std from the ``duration`` seconds after
    the last visual event (reference ``load_meg.py:12-31``)."""
    data = scipy.io.loadmat(meg_filepath)
    MEG_Data = data["F"]
    events = data["Events"][0]
    visual_id = None
    for i in range(len(events)):
        if events[i][0][0] == "visual":
            visual_id = i
            break
    if visual_id is None:
        raise ValueError(f"no visual events in rest file {meg_filepath}")
    onset_timing = events[visual_id][3][0]
    start = int(onset_timing[-1] * fs)
    end = start + int(duration * fs)
    rest = MEG_Data[:, start:end]
    return rest.mean(axis=1), rest.std(axis=1)


def get_meg_data(meg_filepath: str, label_filepath: str,
                 trigger_filepath: str, rest_mean=None, rest_std=None,
                 split: str = "train", num_channels: int = 203,
                 enforce_split_sizes: bool = False):
    """One session's (MEG float64, image_features, labels, triggers)
    (reference ``load_meg.py:34-103``).  ``enforce_split_sizes`` enables the
    reference's GOD cardinality checks (600/50/60)."""
    data = scipy.io.loadmat(meg_filepath)
    MEG_Data = np.asarray(data["F"], dtype=np.float64)
    if len(MEG_Data) != num_channels:
        raise ValueError(f"{meg_filepath}: expected {num_channels} channels, "
                         f"got {len(MEG_Data)}")
    if rest_mean is not None:
        MEG_Data = MEG_Data - rest_mean[:, None]
    if rest_std is not None:
        MEG_Data = MEG_Data / rest_std[:, None]

    label_data = scipy.io.loadmat(label_filepath)
    image_features = np.asarray(label_data["vec_image"])
    labels = np.asarray(label_data["vec_index"][0])
    triggers = np.asarray(scipy.io.loadmat(trigger_filepath)["trigger"][0])
    if enforce_split_sizes and split in _SPLIT_SIZES:
        n = _SPLIT_SIZES[split]
        if not (image_features.shape[0] == len(labels) == len(triggers) == n):
            raise ValueError(
                f"{split} session: expected {n} trials, got features "
                f"{image_features.shape[0]}, labels {len(labels)}, triggers "
                f"{len(triggers)}")
    return MEG_Data, image_features, labels, triggers


def time_window(cfg, triggers: np.ndarray, fs: float,
                start: float | None = None,
                end: float | None = None) -> np.ndarray:
    """Trigger times → (start, end) sample index pairs (reference
    ``load_meg.py:123-130``); ``start``/``end`` override ``cfg.window``."""
    trigger_point = np.round(triggers * fs)
    start_pt = np.round((cfg.window.start if start is None else start) * fs)
    end_pt = np.round((cfg.window.end if end is None else end) * fs)
    return np.stack([(trigger_point + start_pt).astype(int),
                     (trigger_point + end_pt).astype(int)], axis=1)


def _normalize_per_unit(arr: np.ndarray, mean=None, std=None):
    """Per-unit (column) z-scoring with reusable stats (god.py:20-30)."""
    if mean is None:
        mean = np.mean(arr, axis=0, keepdims=True)
        std = np.std(arr, axis=0, keepdims=True)
    return (arr - mean) / std, mean, std


def _epochs(cfg, MEG: np.ndarray, triggers, fs: float, roi_channels,
            onsets, dev: torch.device) -> torch.Tensor:
    """One session's (N, C, L) epochs on ``dev``."""
    if onsets is not None:
        # per-region onset epoching (reference kamitani_regression.py:
        # 95-109): no filter or resample; each region's window starts at its
        # own onset; the parts, trimmed to the shortest (rounding can make
        # them differ by one sample), concatenate along the channel axis
        duration = float(cfg.window.end) - float(cfg.window.start)
        parts = []
        for reg, onset in onsets.items():
            reg_list = [reg] if isinstance(reg, str) else list(reg)
            chans = np.asarray(roi(cfg, region=reg_list), dtype=int)
            xr = torch.from_numpy(MEG[chans].astype(np.float32)).to(dev)
            win = time_window(cfg, triggers, fs, start=float(onset),
                              end=float(onset) + duration)
            parts.append(epoch_slice(xr, win[:, 0], int(win[0, 1] - win[0, 0])))
        min_len = min(int(p.shape[-1]) for p in parts)
        return torch.cat([p[..., :min_len] for p in parts], dim=1)

    x = torch.from_numpy(MEG[roi_channels].astype(np.float32)).to(dev)  # (C, T)
    brain_filter = cfg.preprocs.get("brain_filter")
    if brain_filter is not None:
        x = bandpass_filter(x, fs, float(brain_filter[0]), float(brain_filter[1]))
    rate = cfg.preprocs.get("brain_resample_rate")
    if rate is not None:
        x = resample_fft(x, down=fs / float(rate))
        fs = float(rate)
    windows = time_window(cfg, triggers, fs)
    return epoch_slice(x, windows[:, 0], int(windows[0, 1] - windows[0, 0]))


def build_god_dataset(cfg, split: str, mean_X=None, std_X=None, mean_Y=None,
                      std_Y=None, manual_ch=None, onsets=None,
                      device: str | torch.device = "cuda") -> PackedDataset:
    """The packed GOD dataset for ``split`` ('train' or 'val') on
    ``device`` (``GODDatasetBase.__init__`` + ``prepare_data``,
    god.py:32-152).

    ``manual_ch``: explicit 0-indexed channels instead of the ROI lookup.
    ``onsets``: dict of region → onset seconds; each region's channels are
    epoched at their own (onset, onset + window duration) window of the
    raw-rate recording (no filter or resample) and the parts concatenated
    along the channel axis."""
    dev = resolve_device(device)
    data_root = cfg.data_root
    sub_list = list(cfg.subjects.keys())
    sub_id_map = {s: i for i, s in enumerate(sub_list)}
    roi_channels = np.asarray(manual_ch if manual_ch is not None else roi(cfg),
                              dtype=int)

    meg_epochs, sub_epochs, label_epochs, feat_epochs = [], [], [], []
    for sub in sub_list:
        scfg = cfg.subjects[sub]
        fs = float(scfg["fs"])
        file_split = scfg[split]
        for meg_name, label_name, trig_name, rest_name in zip(
                file_split["mat"], file_split["labels"], file_split["trigger"],
                file_split["rest"]):
            rest_mean = rest_std = None
            if cfg.get("z_scoring", False):
                rest_mean, rest_std = get_baseline(
                    f"{data_root}/{sub}/mat/{rest_name}", fs, cfg.rest_duration)
            MEG, feats, labels, triggers = get_meg_data(
                f"{data_root}/{sub}/mat/{meg_name}",
                f"{data_root}/{sub}/labels/{label_name}",
                f"{data_root}/{sub}/trigger/{trig_name}", rest_mean, rest_std,
                split=split,
                num_channels=int(cfg.get("num_meg_channels", 203)),
                enforce_split_sizes=bool(cfg.get("enforce_split_sizes", False)))
            epochs = _epochs(cfg, MEG, triggers, fs, roi_channels, onsets, dev)
            meg_epochs.append(epochs.cpu().numpy())
            sub_epochs += [sub_id_map[sub]] * len(epochs)
            label_epochs.append(labels)
            feat_epochs.append(feats)

    X = np.concatenate(meg_epochs, axis=0).astype(np.float32)
    Y = np.concatenate(feat_epochs, axis=0).astype(np.float32)
    labels = np.concatenate(label_epochs, axis=0)
    subs = np.asarray(sub_epochs)

    if mean_X is not None:
        X = (X - mean_X) / std_X
    elif cfg.get("normalize_meg", False):
        X, mean_X, std_X = _normalize_per_unit(X)
    if mean_Y is not None:
        Y = (Y - mean_Y) / std_Y
    elif cfg.get("normalize_image_features", False):
        Y, mean_Y, std_Y = _normalize_per_unit(Y)

    if split == "val":
        X, Y, subs, labels = _avg_same_image_sub_epochs(X, Y, subs, labels)

    as_dev = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(dev)
    return PackedDataset(
        X=as_dev(X, torch.float32), Y=as_dev(Y, torch.float32),
        subject_idxs=as_dev(subs, torch.int64),
        labels=as_dev(labels, torch.int64),
        # the CONFIGURED subjects: a subject with no epochs here still owns
        # its row of the per-subject weights
        num_subjects=len(sub_list),
        mean_X=mean_X, std_X=std_X, mean_Y=mean_Y, std_Y=std_Y)


def _avg_same_image_sub_epochs(Xs, Ys, subs, labels):
    """Average epochs sharing (image label, subject) — god.py:154-167."""
    subs = np.asarray(subs)
    avg_X, avg_Y, new_subs, new_labels = [], [], [], []
    for lab in np.unique(labels):
        for s in np.unique(subs):
            flag = (labels == lab) & (subs == s)
            if not np.any(flag):
                continue
            avg_X.append(np.mean(Xs[flag], axis=0, keepdims=True))
            avg_Y.append(np.mean(Ys[flag], axis=0, keepdims=True))
            new_subs.append(s)
            new_labels.append(lab)
    return (np.concatenate(avg_X), np.concatenate(avg_Y), np.asarray(new_subs),
            np.asarray(new_labels))
