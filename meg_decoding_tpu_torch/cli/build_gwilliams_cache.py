"""Build the Gwilliams2022 preprocessed cache from raw BIDS + stimulus audio.
Port of ``scripts/build_gwilliams_cache.py``.

Reference: ``gwilliams2022.py:193-388`` — a 20-process MNE pool filters and
resamples 27×2×4 subject-session-task recordings (~30 min on 20 cores,
README.md:26) and a torch wav2vec pass embeds the stimulus audio.

Split of labor:
* host: BIDS parsing + annotation extraction (needs ``mne_bids`` and
  pandas — install them where you build the cache);
* device: the filter+resample chain of each recording
  (``data/gwilliams.py:preprocess_recordings``, on ``ops/fir.py`` and
  ``ops/resample.py``);
* device: wav2vec2 embedding of the stimulus audio (``features/wav2vec.py``,
  backend ``wav2vec_backend``, default ``hf``: a cache of random-weight
  embeddings would be garbage and marked done for good).

Output: the reference-compatible cache layout
(``x_dict.npy``/``y_dict.npy``/``meg_onsets.npy``/``speech_onsets.npy``/
``sentence_idxs.npy`` under ``{root_dir}/data/Gwilliams2022/preprocessed/<n>/``,
the directory chosen by ``utils/cache.py:check_preprocs``), so caches built
here load in either implementation.

    python -m meg_decoding_tpu_torch.cli.build_gwilliams_cache [--device cuda] \\
        [--config-name config] root_dir=...
"""

from __future__ import annotations

import glob
import json
import os
import sys

import numpy as np
import torch

from meg_decoding_tpu_torch.cli.main import parse_cli, split_device
from meg_decoding_tpu_torch.core.config import to_dict
from meg_decoding_tpu_torch.data.gwilliams import preprocess_recordings
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features import wav2vec
from meg_decoding_tpu_torch.ops.resample import resample_fft, resample_len
from meg_decoding_tpu_torch.utils.cache import check_preprocs, mark_done

__all__ = ["to_second", "continuous_onsets", "accumulate_session",
           "extract_layout", "build_x", "build_y", "main", "TASK_PREFIXES"]

NUM_SUBJECTS = 27
NUM_SESSIONS = 2
NUM_TASKS = 4
TASK_PREFIXES = ["lw", "cable", "easy", "the"]  # gwilliams2022.py:72


def to_second(onset) -> float:
    """Timestamp → seconds, reference semantics (to_second,
    gwilliams2022.py:665-666: minute·60 + second + µs — hours are NOT
    included, recordings being < 1 h)."""
    return onset.minute * 60 + onset.second + onset.microsecond * 1e-6


def continuous_onsets(starts) -> np.ndarray:
    """Make per-audio-file onsets continuous across the concatenated files
    (reference ``continuous``, gwilliams2022.py:669-688): whenever the next
    raw onset is smaller than the current one, a new file started — bump the
    base by the current file's last timestamp."""
    starts = np.asarray(starts, dtype=float)
    out = starts.copy()
    base = 0.0
    for i in range(len(out)):
        bump = i < len(out) - 1 and starts[i + 1] < starts[i]
        if bump:
            nxt = base + starts[i]
        out[i] = starts[i] + base
        if bump:
            base = nxt
    return out


def _extract_annotations(df_annot):
    """word onsets / sentence ids from BIDS annotations
    (reference get_speech_onsets, gwilliams2022.py:701-721): onsets are made
    continuous over ALL annotations (words + phonemes) first, THEN filtered
    to kind == 'word', exactly as the reference does."""
    import ast

    import pandas as pd

    desc = pd.DataFrame(df_annot.description.apply(ast.literal_eval).to_list())
    out = continuous_onsets(desc["start"].to_numpy())
    kinds = desc["kind"].to_numpy()
    word_idx = np.where(kinds == "word")[0]
    meg_onsets = np.array([to_second(o) for o in df_annot.onset])[word_idx]
    return word_idx, out[word_idx], desc["sequence_id"].to_numpy()[word_idx], meg_onsets


def accumulate_session(acc: dict, subj: int, sess: int, task: int, df_annot):
    """Fold one session's annotations into the cache dicts, with the
    reference's cross-subject/session consistency checks
    (gwilliams2022.py:240-244: speech onsets and sentence ids must be
    identical across every subject/session of a task; ValueError here, the
    JAX script asserts).

    ``acc`` maps 'meg_onsets'/'speech_onsets'/'sentence_idxs' → dict.
    Returns the x_dict key for this session.
    """
    _, sp_on, sent, meg_on = _extract_annotations(df_annot)
    key = f"subject{subj + 1:02d}_sess{sess}_task{task}"
    task_key = f"task{task}"
    if task_key in acc["speech_onsets"]:
        if not np.allclose(acc["speech_onsets"][task_key], sp_on):
            raise ValueError(f"Speech onsets are different ({key})")
        if not np.array_equal(acc["sentence_idxs"][task_key], sent):
            raise ValueError(f"Sentence ids are different ({key})")
    acc["speech_onsets"][task_key] = sp_on
    acc["sentence_idxs"][task_key] = sent
    acc["meg_onsets"][key] = meg_on
    return key


def extract_layout(info, n_channels: int = 208) -> np.ndarray:
    """2-D sensor layout from a recording's measurement info, exactly as the
    reference builds it at model-construction time
    (``layout.py:30-32``: ``find_layout(raw.info, 'meg').pos[:, :2]``),
    sliced to the same leading ``n_channels`` the MEG data keeps.  Stored
    as ``layout.npy`` beside ``x_dict.npy`` so training needs no MNE."""
    import mne

    layout = mne.channels.find_layout(info, ch_type="meg")
    return np.asarray(layout.pos[:n_channels, :2], dtype=np.float32)


def build_x(cfg, cache_dir: str, device: str | torch.device = "cuda") -> None:
    try:
        import mne  # noqa: F401
        import mne_bids
    except ImportError as e:
        raise SystemExit(
            "mne_bids is required to parse the raw BIDS recordings (not in "
            "this image). Build the cache on a host with mne_bids installed, "
            "or provide a prepared cache (data/gwilliams.py docstring)."
        ) from e

    dev = resolve_device(device)
    pre = cfg.preprocs
    root = os.path.join(cfg.root_dir, "data", "Gwilliams2022")
    x_dict = {}
    layout = None
    acc = {"meg_onsets": {}, "speech_onsets": {}, "sentence_idxs": {}}
    # one recording at a time: each raw is ~650 MB as f64 and there are up
    # to 216 of them; the FFT resample of each stays exact at its own length
    for subj in range(NUM_SUBJECTS):
        for sess in range(NUM_SESSIONS):
            for task in range(NUM_TASKS):
                bids_path = mne_bids.BIDSPath(
                    subject=str(subj + 1).zfill(2), session=str(sess),
                    task=str(task), datatype="meg", root=root,
                )
                try:
                    raw = mne_bids.read_raw_bids(bids_path)
                except (OSError, ValueError, RuntimeError):
                    continue  # no such subject/session/task
                if layout is None:
                    # the reference reads the layout from the FIRST BIDS
                    # recording (layout.py:20-32)
                    layout = extract_layout(raw.info)
                df = raw.to_data_frame()
                key = accumulate_session(acc, subj, sess, task,
                                         raw.annotations.to_data_frame())
                meg = np.stack(
                    [df[k] for k in df.keys() if "MEG" in k]
                )[:208].astype(np.float32)
                del raw, df
                out = preprocess_recordings(
                    meg[None], 1000.0, float(pre.brain_filter_low),
                    float(pre.brain_filter_high),
                    float(pre.brain_resample_rate), device=dev)
                n_out = resample_len(meg.shape[1],
                                     down=1000.0 / float(pre.brain_resample_rate))
                x_dict[key] = out[0, :, :n_out].cpu().numpy()

    if layout is not None:
        np.save(os.path.join(cache_dir, "layout.npy"), layout)
    # the channel count for metadata-only consumers (an empty build writes
    # no sidecar)
    if x_dict:
        C_data = int(next(iter(x_dict.values())).shape[0])
        with open(os.path.join(cache_dir, "meta.json"), "w") as f:
            json.dump({"num_channels": C_data}, f)
    np.save(os.path.join(cache_dir, "x_dict.npy"), x_dict, allow_pickle=True)
    for name in ("meg_onsets", "speech_onsets", "sentence_idxs"):
        np.save(os.path.join(cache_dir, f"{name}.npy"), acc[name],
                allow_pickle=True)
    mark_done(cache_dir, "x_done")


def build_y(cfg, cache_dir: str, device: str | torch.device = "cuda") -> dict:
    """The stimulus embeddings: for each task, its ``{prefix}*.wav`` files
    under ``{root_dir}/data/Gwilliams2022/stimuli/audio`` in name order,
    each brought to ``audio_resample_rate``, embedded (last-4 average) and
    resampled to the brain rate, then concatenated → ``y_dict.npy``
    ``{taskN: (F, T)}``.  Returns the dict."""
    dev = resolve_device(device)
    pre = cfg.preprocs
    audio_dir = os.path.join(cfg.root_dir, "data", "Gwilliams2022", "stimuli",
                             "audio")
    model = wav2vec.load_wav2vec(
        cfg.get("wav2vec_model") or "facebook/wav2vec2-large-xlsr-53",
        backend=cfg.get("wav2vec_backend", "hf"), device=dev)
    target = int(pre.audio_resample_rate)
    y_dict = {}
    for t, prefix in enumerate(TASK_PREFIXES):
        paths = sorted(glob.glob(os.path.join(audio_dir, f"{prefix}*.wav")))
        if not paths:
            raise FileNotFoundError(f"no audio for task {t} under {audio_dir}")
        chunks = []
        for p in paths:
            sr, w = wav2vec.read_wav(p)
            w = torch.from_numpy(w).to(dev)
            if sr != target:
                w = resample_fft(w[None], down=sr / target)[0]
            emb = wav2vec.embed_last4_avg(model, w)
            rate_w2v = target * emb.shape[-1] / w.shape[0]
            chunks.append(resample_fft(
                emb, up=float(pre.brain_resample_rate) / rate_w2v))
        y_dict[f"task{t}"] = torch.cat(chunks, dim=-1).cpu().numpy()
    np.save(os.path.join(cache_dir, "y_dict.npy"), y_dict, allow_pickle=True)
    mark_done(cache_dir, "y_done")
    return y_dict


def main(argv=None) -> str:
    """Choose the cache directory (``check_preprocs`` over
    ``{root_dir}/data/Gwilliams2022/preprocessed``), then build what is not
    done yet (everything with ``rebuild_dataset``).  Returns the
    directory."""
    argv, device = split_device(sys.argv[1:] if argv is None else argv)
    cfg = parse_cli(argv, default_config_name="config")
    base = os.path.join(cfg.root_dir, "data", "Gwilliams2022", "preprocessed")
    cache_dir, x_done, y_done = check_preprocs(to_dict(cfg.preprocs), base)
    print("cache dir:", cache_dir)
    if not x_done or cfg.get("rebuild_dataset", False):
        build_x(cfg, cache_dir, device)
    if not y_done or cfg.get("rebuild_dataset", False):
        build_y(cfg, cache_dir, device)
    print("done")
    return cache_dir


if __name__ == "__main__":
    main()
