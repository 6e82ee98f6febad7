"""Gwilliams2022 (MEG ↔ naturalistic speech) dataset, packed on the device.
Port of ``meg_decoding_tpu/data/gwilliams.py`` (cache I/O, splits, packing
and the batch gather).

Reference: ``meg_decoding/dataclass/gwilliams2022.py`` — the preprocessed
cache ``x_dict.npy`` {subjectNN_sessS_taskT → (208, T)}, ``y_dict.npy``
{taskN → (1024, T)} and onset/sentence tables (:64-109); ``__getitem__``
slices a 3 s window of a **random subject-session** holding the segment's
task (:130-143).

Both X and Y stay continuous on the device ((sessions, 4, C, T) padded
recordings, (4, F, T) embedding streams) and a batch is two window gathers
(``ops/kernels/window_gather.py``), one for X and one for Y.

``to_host`` spills a packed split to host memory (pinned when it comes
from the card); its batches are then sliced on the host
(``_gather_batch_host``) and copied to the card by the prefetch
(``data/prefetch.py``).

``compute_collate_stats`` sweeps every (session, task, word) window once
and keeps its RobustScaler fit, so the cached collate
(``ops/scaling.py:collate_preprocess_cached``) needs no percentiles per
step.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from meg_decoding_tpu_torch.data.packed import host_copy, host_index
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.ops.fir import bandpass_filter
from meg_decoding_tpu_torch.ops.kernels.window_gather import (
    pad_time_for_gather,
    window_gather,
)
from meg_decoding_tpu_torch.ops.resample import resample_fft
from meg_decoding_tpu_torch.ops.scaling import baseline_correct, robust_stats

__all__ = ["GwilliamsPacked", "load_gwilliams_cache", "parse_sessions",
           "build_gwilliams_dataset", "sentence_split", "deep_split",
           "drop_overlapping_words", "gather_speech_batch",
           "draw_sessions", "to_host", "compute_collate_stats",
           "collate_stats_chunk",
           "collate_stats_rows", "preprocess_recordings"]

NUM_TASKS = 4
SWEEP_CHUNK = 512  # windows per chunk of the collate-stats sweep, as JAX


# ---------------------------------------------------------------------------
# cache I/O (reference-compatible layout)
# ---------------------------------------------------------------------------

def load_gwilliams_cache(cache_dir: str):
    """Load the reference-format preprocessed cache dicts."""
    def load(name):
        return np.load(os.path.join(cache_dir, name), allow_pickle=True).item()

    return (load("x_dict.npy"), load("y_dict.npy"), load("meg_onsets.npy"),
            load("speech_onsets.npy"), load("sentence_idxs.npy"))


def parse_sessions(keys):
    """Sessions with all ``NUM_TASKS`` tasks present (cache keys
    ``{subj}_{sess}_{task}``), and the sorted subject list."""
    keys = sorted(keys)
    sess_names = sorted({"_".join(k.split("_")[:-1]) for k in keys})
    sess_names = [s for s in sess_names
                  if sum(1 for k in keys if k.startswith(s + "_")) == NUM_TASKS]
    subjects = sorted({s.split("_")[0] for s in sess_names})
    return sess_names, subjects


def preprocess_recordings(raw, fs: float, l_freq: float, h_freq: float,
                          new_rate: float,
                          device: str | torch.device = "cuda") -> torch.Tensor:
    """Bandpass + resample a stack of recordings (..., C, T) on ``device``:
    the device replacement for the reference's 20-process MNE pool
    (gwilliams2022.py:254-261, 299-306), on ``ops/fir.py`` and
    ``ops/resample.py``.  ``raw`` is a numpy array or a tensor; returns an
    f32 tensor on ``device``."""
    dev = resolve_device(device)
    x = torch.as_tensor(raw).to(device=dev, dtype=torch.float32)
    x = bandpass_filter(x, fs, l_freq, h_freq)
    return resample_fft(x, down=fs / new_rate)


# ---------------------------------------------------------------------------
# splits (host-side index logic; reference gwilliams2022.py:391-638)
# ---------------------------------------------------------------------------

def sentence_split(sentence_idxs: dict, split_ratio: float, seed: int = 0):
    """Sentence-granularity split: shuffle sentence ids per task, 80/20, map
    back to word indices (Gwilliams2022SentenceSplit, :425-451)."""
    rng = np.random.RandomState(seed)
    train_word_idxs, test_word_idxs = {}, {}
    for task, sidxs in sentence_idxs.items():
        uniq = np.unique(sidxs)
        rng.shuffle(uniq)
        split = int(len(uniq) * split_ratio)
        train_s = set(uniq[:split].tolist())
        words = np.arange(len(sidxs))
        is_train = np.asarray([s in train_s for s in sidxs])
        train_word_idxs[task] = words[is_train]
        test_word_idxs[task] = words[~is_train]
    return train_word_idxs, test_word_idxs


def drop_overlapping_words(word_idxs: dict, other_idxs: dict,
                           speech_onsets: dict, seq_len_sec: float):
    """Drop words whose ``seq_len_sec`` window reaches past the onset of any
    word of the *other* split (the reference's TODO at
    gwilliams2022.py:691-698)."""
    out = {}
    for task, widx in word_idxs.items():
        onsets = np.asarray(speech_onsets[task], float)
        other = np.sort(onsets[other_idxs[task]])
        if len(other) == 0:
            out[task] = widx
            continue
        keep = []
        for w in widx:
            j = np.searchsorted(other, onsets[w], side="right")
            if j >= len(other) or other[j] >= onsets[w] + seq_len_sec:
                keep.append(w)
        out[task] = np.asarray(keep, dtype=int)
    return out


def deep_split(speech_onsets: dict, split_ratio: float):
    """Temporal head/tail split per task (Gwilliams2022DeepSplit, :591-629)."""
    train_word_idxs, test_word_idxs = {}, {}
    for task, onsets in speech_onsets.items():
        n = len(onsets)
        cut = int(n * split_ratio)
        train_word_idxs[task] = np.arange(cut)
        test_word_idxs[task] = np.arange(cut, n)
    return train_word_idxs, test_word_idxs


# ---------------------------------------------------------------------------
# packed dataset
# ---------------------------------------------------------------------------

@dataclass
class GwilliamsPacked:
    """Device-resident packed Gwilliams dataset (one split).

    recordings: (n_sessions, 4, C, T_max) f32 padded MEG at the brain rate,
      already shifted 150 ms (X side).
    y_stream:   (4, F, Ty_max) f32 padded embedding streams (end-cropped).
    meg_onsets: (n_sessions, 4, W_max) int32 sample onsets (this split's words).
    speech_onsets: (4, W_max) int32 sample onsets into y_stream.
    n_words:    (4,) numpy valid word counts per task for this split.
    session_subject: (n_sessions,) int64 subject index of each session.
    seq_len: segment length in samples (360).
    host_resident: the tensors live in host memory (``to_host``).
    """

    recordings: torch.Tensor
    y_stream: torch.Tensor
    meg_onsets: torch.Tensor
    speech_onsets: torch.Tensor
    n_words: np.ndarray
    session_subject: torch.Tensor
    seq_len: int
    num_subjects: int
    _seg_table: np.ndarray | None = None  # lazily built, immutable per split
    host_resident: bool = False

    def __len__(self):
        return int(self.n_words.sum())

    @property
    def num_sessions(self) -> int:
        return int(self.recordings.shape[0])

    @property
    def num_channels(self) -> int:
        return int(self.recordings.shape[2])

    def gather(self, segment_ids, generator: torch.Generator | None = None):
        """``gather_speech_batch`` with the sessions drawn from
        ``generator``: ``(X, Y, subject_idxs, segment_ids)``."""
        return gather_speech_batch(self, segment_ids, generator=generator)

    def segment_table(self) -> np.ndarray:
        """(N, 2) rows (task, i_in_task) for global segment ids (cached)."""
        if self._seg_table is None:
            rows = [np.stack([np.full(n, t), np.arange(n)], 1)
                    for t, n in enumerate(self.n_words)]
            self._seg_table = np.concatenate(rows, axis=0)
        return self._seg_table


def _gather_batch(recordings, y_stream, meg_onsets, speech_onsets,
                  session_subject, task_ids, i_in_task, sess_ids, seq_len,
                  y_dtype=None):
    """(X, Y, subject) windows for a batch: two launches of the window
    gather, X from the session recordings and Y from the task's stream.
    ``y_dtype`` optionally casts Y inside the gather (bf16); X stays f32 —
    the collate's RobustScaler must see the recorded values."""
    S, NT, C, T = recordings.shape
    rec_flat = recordings.reshape(S * NT, C, T)
    rec_ids = sess_ids * NT + task_ids

    x_onsets = meg_onsets[sess_ids, task_ids, i_in_task]        # (B,)
    X = window_gather(rec_flat, rec_ids, x_onsets, seq_len)     # (B, C, L)

    y_onsets = speech_onsets[task_ids, i_in_task]
    Y = window_gather(y_stream, task_ids, y_onsets, seq_len,
                      out_dtype=y_dtype)                        # (B, F, L)
    return X, Y, session_subject[sess_ids]


def draw_sessions(ds: GwilliamsPacked, n: int,
                  generator: torch.Generator | None) -> torch.Tensor:
    """``n`` sessions drawn uniformly with ``generator`` (a CPU
    ``torch.Generator``): the reference's random subject-session pairing."""
    if generator is None:
        raise ValueError("pass sess_ids or a torch.Generator to draw them")
    return torch.randint(0, ds.num_sessions, (n,), generator=generator)


def gather_speech_batch(ds: GwilliamsPacked, segment_ids: np.ndarray,
                        sess_ids=None, generator: torch.Generator | None = None,
                        y_dtype: torch.dtype | None = None):
    """Batch = segments by global id + one session each (the reference's
    random subject-session pairing, ``__getitem__`` :130-143).

    Sessions come from ``sess_ids`` when given, else are drawn uniformly
    with ``generator`` (``draw_sessions``).  ``y_dtype`` casts Y inside the
    gather (see ``_gather_batch``).  On a host-resident split
    (``to_host``) the windows are host slices from the same draw
    (``_gather_batch_host``).  Returns
    ``(X, Y, subject_idxs, segment_ids)``."""
    seg = ds.segment_table()[np.asarray(segment_ids)]
    if sess_ids is None:
        sess_ids = draw_sessions(ds, len(seg), generator)
    if ds.host_resident:
        if y_dtype is not None:
            raise ValueError("y_dtype casts inside the device gather; a "
                             "host-resident split gathers on the host")
        X, Y, subs = _gather_batch_host(ds, seg[:, 0], seg[:, 1],
                                        np.asarray(sess_ids))
        return X, Y, subs, np.asarray(segment_ids)
    dev = ds.recordings.device
    sess_ids = torch.as_tensor(np.asarray(sess_ids), dtype=torch.int64,
                               device=dev)
    task_ids = torch.as_tensor(seg[:, 0], dtype=torch.int64, device=dev)
    i_in_task = torch.as_tensor(seg[:, 1], dtype=torch.int64, device=dev)
    X, Y, subs = _gather_batch(
        ds.recordings, ds.y_stream, ds.meg_onsets, ds.speech_onsets,
        ds.session_subject, task_ids, i_in_task, sess_ids, ds.seq_len,
        y_dtype=y_dtype)
    return X, Y, subs, np.asarray(segment_ids)


def to_host(ds: GwilliamsPacked, buffer_cache: dict | None = None
            ) -> GwilliamsPacked:
    """The split in host memory (``packed.host_copy``: pinned when it comes
    from the card), for recordings that exceed the card's memory.  Its
    batches are host slices (``gather_speech_batch``) streamed through the
    prefetch (``data/prefetch.py``; ``host_resident: true`` and
    ``prefetch: N`` on the speech trainer).

    ``buffer_cache`` (a dict, keyed by the source tensor's storage): pass
    the same dict when spilling splits that share tensors (sentence and
    deep splits share the recordings, the streams and the session table
    across two packed objects, ``build_gwilliams_dataset``), so that each
    is copied to the host once and the host copy is shared.  Keep every
    source split alive until its spills through one cache are done: the
    keys are addresses of live storages."""
    if ds.host_resident:
        return ds
    cache = {} if buffer_cache is None else buffer_cache

    def pull(t: torch.Tensor) -> torch.Tensor:
        key = (str(t.device), t.untyped_storage().data_ptr(),
               t.storage_offset(), tuple(t.shape), tuple(t.stride()))
        if key not in cache:
            cache[key] = host_copy(t)
        return cache[key]

    return dataclasses.replace(
        ds, recordings=pull(ds.recordings), y_stream=pull(ds.y_stream),
        meg_onsets=pull(ds.meg_onsets), speech_onsets=pull(ds.speech_onsets),
        session_subject=pull(ds.session_subject), host_resident=True)


def _gather_batch_host(ds: GwilliamsPacked, task_ids, i_in_task, sess_ids):
    """Host twin of ``_gather_batch``, as JAX's ``_gather_batch_host``
    (``data/gwilliams.py:534-549``): the same windows, cut on the host into
    pinned batches when the split is pinned.  Onsets are clamped to
    [0, T − L] as JAX's host gather clamps them; the device gather clamps to
    T − padded_window(L).  The two differ only for an onset past
    T − padded_window(L); in a packed split everything from there on is
    the zero padding of ``pad_time_for_gather``, so both windows are
    zeros."""
    L = int(ds.seq_len)
    task, i_in, sess = (torch.from_numpy(np.array(a, dtype=np.int64))
                        for a in (task_ids, i_in_task, sess_ids))
    T, Ty = ds.recordings.shape[-1], ds.y_stream.shape[-1]
    x_on = ds.meg_onsets[sess, task, i_in].clamp(0, T - L).tolist()
    y_on = ds.speech_onsets[task, i_in].clamp(0, Ty - L).tolist()
    B, C, F = len(sess), ds.recordings.shape[2], ds.y_stream.shape[1]
    X = torch.empty((B, C, L), dtype=ds.recordings.dtype,
                    pin_memory=ds.recordings.is_pinned())
    Y = torch.empty((B, F, L), dtype=ds.y_stream.dtype,
                    pin_memory=ds.y_stream.is_pinned())
    # one stack per output: the window views are made under the GIL, the
    # copy runs in one call that releases it (a copy per window would wait
    # for the GIL once per window while the training thread holds it)
    torch.stack([ds.recordings[s, t, :, o:o + L]
                 for s, t, o in zip(sess.tolist(), task.tolist(), x_on)], out=X)
    torch.stack([ds.y_stream[t, :, o:o + L]
                 for t, o in zip(task.tolist(), y_on)], out=Y)
    return X, Y, host_index(ds.session_subject, sess)


def collate_stats_chunk(recordings: torch.Tensor, rec_ids: torch.Tensor,
                        onsets: torch.Tensor, seq_len: int,
                        baseline_len_samp: int) -> torch.Tensor:
    """The RobustScaler fits of a chunk of windows: one ``window_gather``
    of windows ``rec_ids``/``onsets`` out of the (S, NT, C, T) recordings,
    ``baseline_correct``, then ``robust_stats`` — the inline collate's own
    ops (``ops/scaling.py:collate_preprocess``).  Returns (n, 2C) f32:
    [:, :C] median, [:, C:] IQR."""
    S, NT, C, T = recordings.shape
    X = window_gather(recordings.reshape(S * NT, C, T), rec_ids, onsets,
                      seq_len)
    if baseline_len_samp > 0:
        X = baseline_correct(X, baseline_len_samp)
    med, iqr = robust_stats(X, axis=-1)
    return torch.cat([med, iqr], dim=1)


def compute_collate_stats(ds: GwilliamsPacked, baseline_len_samp: int,
                          chunk: int = SWEEP_CHUNK) -> torch.Tensor:
    """The epoch-invariant RobustScaler fit of every window a batch can
    hold, as a flat (S·NT·W, 2C) table on the dataset's device: row
    ``(s·NT + t)·W + w`` is session s, task t, word w; [:, :C] median,
    [:, C:] IQR of the baseline-corrected window.  Port of
    ``compute_collate_stats`` (``data/gwilliams.py:292-358``), single
    device.

    One sweep in chunks of ``chunk`` windows (``collate_stats_chunk``),
    each chunk's gathered windows freed before the next; the last chunk is
    as short as the rest of the grid.  Rows of words past a task's
    ``n_words`` fit the zero onset's window and are never read.  The JAX
    package pads each half to 128 lanes for the TPU's tiling
    (``stats_lane_pad``); the card needs no padding, so the table is
    ~0.6 of JAX's."""
    S, NT, C, _ = ds.recordings.shape
    W = int(ds.meg_onsets.shape[2])
    total = S * NT * W
    dev = ds.recordings.device
    onsets = ds.meg_onsets.reshape(total)
    rec_ids = torch.arange(S * NT, dtype=torch.int32,
                           device=dev).repeat_interleave(W)
    table = torch.empty((total, 2 * C), dtype=torch.float32, device=dev)
    for start in range(0, total, chunk):
        stop = min(start + chunk, total)
        table[start:stop] = collate_stats_chunk(
            ds.recordings, rec_ids[start:stop], onsets[start:stop],
            int(ds.seq_len), baseline_len_samp)
    return table


def collate_stats_rows(ds: GwilliamsPacked, table: torch.Tensor,
                       task_ids: torch.Tensor, i_in_task: torch.Tensor,
                       sess_ids: torch.Tensor) -> torch.Tensor:
    """The (B, 2C) rows of ``compute_collate_stats``'s table for a batch's
    (session, task, word) windows, gathered on the device."""
    NT, W = int(ds.meg_onsets.shape[1]), int(ds.meg_onsets.shape[2])
    return table[(sess_ids * NT + task_ids) * W + i_in_task]


def build_gwilliams_dataset(cfg, x_dict: dict, y_dict: dict, meg_onsets: dict,
                            speech_onsets: dict, sentence_idxs: dict,
                            split_mode: str = "shallow", seed: int = 0,
                            device: str | torch.device = "cuda"):
    """Pack the cache dicts into device tensors; returns (train, test) for
    sentence/deep splits or a single packed dataset for shallow.

    Sessions with missing tasks are dropped (gwilliams2022.py:183-191);
    recordings are zero-padded to the longest, and the time axes to
    ``pad_time_for_gather`` — the gather's clamp bound depends on it."""
    dev = resolve_device(device)
    pre = cfg.preprocs
    rate = float(pre.brain_resample_rate)
    seq_len = int(rate * float(pre.seq_len_sec))
    shift = int(rate * float(pre.get("shift_len", 150)) / 1000) \
        if pre.get("shift_brain", True) else 0

    sess_names, subjects = parse_sessions(x_dict.keys())
    subject_of = {s: subjects.index(s.split("_")[0]) for s in sess_names}

    n_sessions = len(sess_names)
    tasks = [f"task{t}" for t in range(NUM_TASKS)]
    C = next(iter(x_dict.values())).shape[0]
    F = next(iter(y_dict.values())).shape[0]
    T_max = pad_time_for_gather(
        max(v.shape[1] for v in x_dict.values()) - shift, seq_len)
    Ty_max = pad_time_for_gather(
        max(v.shape[1] for v in y_dict.values()) - shift, seq_len)

    recordings = np.zeros((n_sessions, NUM_TASKS, C, T_max), dtype=np.float32)
    for si, sname in enumerate(sess_names):
        for t, task in enumerate(tasks):
            v = x_dict[f"{sname}_{task}"][:, shift:]  # X shifted forward
            recordings[si, t, :, : v.shape[1]] = v
    y_stream = np.zeros((NUM_TASKS, F, Ty_max), dtype=np.float32)
    for t, task in enumerate(tasks):
        v = y_dict[task]
        v = v[:, : v.shape[1] - shift] if shift else v  # Y end-cropped
        y_stream[t, :, : v.shape[1]] = v

    def word_onsets_samples(d):  # seconds → sample indices (·rate, round)
        return {k: np.round(np.asarray(v) * rate).astype(int) for k, v in d.items()}

    meg_on = word_onsets_samples(meg_onsets)
    sp_on = word_onsets_samples(speech_onsets)

    if split_mode == "sentence":
        tr_idx, te_idx = sentence_split(sentence_idxs, float(cfg.split_ratio), seed)
        if cfg.get("drop_overlapping", False):
            seq_sec = float(pre.seq_len_sec)
            tr_idx = drop_overlapping_words(tr_idx, te_idx, speech_onsets,
                                            seq_sec)
            te_idx = drop_overlapping_words(te_idx, tr_idx, speech_onsets,
                                            seq_sec)
        splits = [tr_idx, te_idx]
    elif split_mode == "deep":
        splits = list(deep_split(speech_onsets, float(cfg.split_ratio)))
    else:  # shallow: one packed set (random_split over segments happens later)
        splits = [{t: np.arange(len(sp_on[t])) for t in tasks}]

    # the splits differ ONLY in their onset tables — the recordings, streams
    # and session table are uploaded once and shared by every split
    recordings_dev = torch.from_numpy(recordings).to(dev)
    y_stream_dev = torch.from_numpy(y_stream).to(dev)
    session_subject_dev = torch.tensor([subject_of[s] for s in sess_names],
                                       dtype=torch.int64, device=dev)

    out = []
    for word_idxs in splits:
        n_words = np.asarray([len(word_idxs[t]) for t in tasks])
        W_max = max(int(n_words.max()), 1)
        mo = np.zeros((n_sessions, NUM_TASKS, W_max), dtype=np.int32)
        so = np.zeros((NUM_TASKS, W_max), dtype=np.int32)
        for t, task in enumerate(tasks):
            widx = word_idxs[task]
            so[t, : len(widx)] = sp_on[task][widx]
            for si, sname in enumerate(sess_names):
                mo[si, t, : len(widx)] = meg_on[f"{sname}_{task}"][widx]
        out.append(GwilliamsPacked(
            recordings=recordings_dev,
            y_stream=y_stream_dev,
            meg_onsets=torch.from_numpy(mo).to(dev),
            speech_onsets=torch.from_numpy(so).to(dev),
            n_words=n_words,
            session_subject=session_subject_dev,
            seq_len=seq_len,
            num_subjects=len(subjects),
        ))
    return tuple(out) if len(out) > 1 else out[0]
