"""Brennan2018 (EEG ↔ audiobook) dataset builder.  Port of
``meg_decoding_tpu/data/brennan.py`` (without ``to_host``: the host spill
path is not ported).

Reference: ``meg_decoding/dataclass/brennan2018.py`` — 49 raw .mat EEG files →
exclude 16 low-comprehension subjects (:216-233) → keep first 60 channels,
trim to the shortest recording (:244-258) → bandpass 1-60 Hz → resample so
EEG length matches the wav2vec embedding stream (:263-270) → 150 ms shift
(:289-301) → RobustScaler+clamp subject-wise or pooled (:109-134) → split
into fixed-length segments → per-segment baseline correction (:136-142).
``__getitem__`` returns a **random subject's** EEG for chunk i (:147-152).

The recordings are read on the host; everything after runs on one device:
the FIR and FFT resample of ``ops/fir.py`` and ``ops/resample.py``, and the
robust scale, whose percentiles come from the quantile kernel on the card.
Its rows are whole recordings (≈ 89,000 keys a subject's channel at 120 Hz,
S times that pooled), so they take the kernel's global-memory path.  A
batch is then a gather of (chunk, random subject) from the packed chunks.

The reference's ``split(num_segments)`` passes the segment *count* as
torch.split's chunk-size argument (:103-104), so its effective segment
length is ``num_segments`` samples.  Segments are ``seq_len_samp`` long
here, as intended; ``faithful_split=True`` reproduces the literal
behaviour (SURVEY §7 hard-part 7).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.io
import torch

from meg_decoding_tpu_torch.data.packed import host_copy, host_index
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.features import wav2vec
from meg_decoding_tpu_torch.ops.fir import bandpass_filter
from meg_decoding_tpu_torch.ops.resample import resample_fft
from meg_decoding_tpu_torch.ops.scaling import baseline_correct, robust_scale
from meg_decoding_tpu_torch.utils.profiling import batch_ids, span

__all__ = ["EXCLUDED_SUBJECTS", "load_brennan_eeg", "build_brennan_dataset",
           "embed_brennan_audio",
           "BrennanPacked"]

# comprehension-score exclusions (brennan2018.py:216-233)
EXCLUDED_SUBJECTS = [
    "S02", "S07", "S09", "S23", "S24", "S27", "S28", "S29", "S30", "S31",
    "S32", "S33", "S43", "S46", "S47", "S49",
]


def load_brennan_eeg(raw_dir: str, num_channels: int = 60,
                     expected_fs: float = 500.0):
    """Load + trim the usable subjects' raw EEG → (S, C, T) float64, fs."""
    paths = sorted(glob.glob(os.path.join(raw_dir, "*.mat")))
    paths = [p for p in paths
             if os.path.basename(p).split(".")[0][-3:] not in EXCLUDED_SUBJECTS]
    if not paths:
        raise FileNotFoundError(f"no usable subject .mat files under {raw_dir}")
    eegs, fss = [], []
    for p in paths:
        mat_raw = scipy.io.loadmat(p)["raw"][0, 0]
        eeg = np.asarray(mat_raw["trial"][0, 0][:num_channels], dtype=np.float64)
        fs = float(np.asarray(mat_raw["fsample"]).reshape(-1)[0])
        if fs != expected_fs:
            raise ValueError(f"{p} has wrong srate {fs}")
        eegs.append(eeg)
        fss.append(fs)
    trim = min(e.shape[1] for e in eegs)
    X = np.stack([e[:, :trim] for e in eegs])
    return X, fss[0]


class BrennanPacked:
    """Packed Brennan dataset on one device.

    X: (num_chunks, S, C, L) baseline-corrected segments;
    Y: (num_chunks, F, L) embedding segments.
    ``to_host`` spills them to host memory (``host_resident``), where a
    gather slices on the host.
    A training sample = (chunk i, random subject), reproducing
    ``__getitem__``'s distribution (:147-152)."""

    def __init__(self, X_chunks: torch.Tensor, Y_chunks: torch.Tensor,
                 host_resident: bool = False):
        self.X = X_chunks
        self.Y = Y_chunks
        self.num_subjects = int(X_chunks.shape[1])
        self.host_resident = host_resident

    def __len__(self):
        return int(self.X.shape[0])

    @property
    def num_channels(self) -> int:
        return int(self.X.shape[2])

    def gather(self, idx, subject_idxs=None,
               generator: torch.Generator | None = None):
        """``(X[idx, subs], Y[idx], subs, idx)``: one subject per chunk,
        from ``subject_idxs`` when given, else drawn uniformly with
        ``generator`` (never a global RNG).  idx doubles as the chunk ids
        (reference train.py:193).  A ``data.gather`` span
        (``utils/profiling.py``)."""
        with span("data.gather", "batch", next(batch_ids)):
            dev = self.X.device
            idx = np.asarray(idx)
            if subject_idxs is None:
                if generator is None:
                    raise ValueError("pass subject_idxs or a torch.Generator "
                                     "to draw them")
                subject_idxs = torch.randint(
                    0, self.num_subjects, (len(idx),), generator=generator,
                    device=generator.device)
            subs = torch.as_tensor(subject_idxs, dtype=torch.int64,
                                   device=dev)
            if self.host_resident:  # host slices, into pinned memory
                N, S = self.X.shape[:2]
                flat = self.X.reshape(N * S, *self.X.shape[2:])
                return (host_index(flat, torch.as_tensor(idx) * S + subs),
                        host_index(self.Y, idx), subs, idx)
            idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
            return self.X[idx_t, subs], self.Y[idx_t], subs, idx

    def subset(self, idx) -> "BrennanPacked":
        if self.host_resident:
            return BrennanPacked(host_index(self.X, idx),
                                 host_index(self.Y, idx), host_resident=True)
        idx_t = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                                device=self.X.device)
        return BrennanPacked(self.X[idx_t], self.Y[idx_t])

    def to_host(self) -> "BrennanPacked":
        """The packed chunks in host memory (see ``PackedDataset.to_host``)."""
        return BrennanPacked(host_copy(self.X), host_copy(self.Y),
                             host_resident=True)


def build_brennan_dataset(cfg, Y_stream, X_raw=None, fs: float | None = None,
                          faithful_split: bool = False,
                          device: str | torch.device = "cuda"
                          ) -> BrennanPacked:
    """The Brennan preprocessing chain on ``device``.

    Y_stream: (F, T_y) wav2vec embeddings already at the brain rate (numpy
    or a tensor).  X_raw: (S, C, T_raw) raw EEG at ``fs`` (numpy or a
    tensor); if None, loaded from ``{root_dir}/data/Brennan2018/raw``."""
    dev = resolve_device(device)
    pre = cfg.preprocs
    if X_raw is None:
        X_raw, fs = load_brennan_eeg(f"{cfg.root_dir}/data/Brennan2018/raw")
    S, C, T_raw = X_raw.shape

    x = torch.as_tensor(X_raw, device=dev).to(torch.float32)
    x = bandpass_filter(x, fs, float(pre.brain_filter_low),
                        float(pre.brain_filter_high))
    # resample EEG so its length matches the embedding stream (brennan :269-270)
    audio_len = Y_stream.shape[-1]
    x = resample_fft(x, up=audio_len / x.shape[-1])
    srate = fs * audio_len / T_raw
    y = torch.as_tensor(Y_stream, device=dev).to(torch.float32)

    # 150 ms shift: EEG forward, audio cropped (brennan :289-301)
    if pre.get("shift_brain", True):
        shift = int(srate * (float(pre.get("shift_len", 150)) / 1000))
        x = x[..., shift:]
        y = y[..., : y.shape[-1] - shift]
    T = min(x.shape[-1], y.shape[-1])
    x, y = x[..., :T], y[..., :T]

    seq_len_samp = int(float(pre.seq_len_sec) * srate)
    num_segments = T // seq_len_samp
    if faithful_split:
        # reference's literal behaviour: chunk size = num_segments samples
        seg_len = num_segments
        num_segments = T // seg_len
    else:
        seg_len = seq_len_samp
    trim = num_segments * seg_len
    x, y = x[..., :trim].contiguous(), y[..., :trim]

    # robust scale per subject over the full recording, or over the
    # subjects pooled (brennan :109-134)
    if pre.get("subject_wise", True):
        x = robust_scale(x, axis=-1)
    else:
        flat = robust_scale(x.transpose(0, 1).reshape(C, -1), axis=-1)
        x = flat.reshape(C, S, -1).transpose(0, 1)
    if pre.get("clamp", True):
        lim = float(pre.clamp_lim)
        x = x.clamp(-lim, lim)

    # segment: (S, C, trim) → (num_segments, S, C, seg_len)
    Xc = x.reshape(S, C, num_segments, seg_len).permute(2, 0, 1, 3).contiguous()
    Yc = y.reshape(y.shape[0], num_segments, seg_len).transpose(0, 1).contiguous()

    # per-chunk baseline correction (brennan :136-142)
    baseline_len = int(seg_len * float(pre.baseline_len_sec)
                       / float(pre.seq_len_sec))
    if baseline_len > 0:
        Xc = baseline_correct(Xc, baseline_len)
    return BrennanPacked(Xc, Yc)


def embed_brennan_audio(cfg, y_path: str,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """Audio → wav2vec last-4 (or conv features) → resample to the brain
    rate (brennan2018.py:154-212), saved to ``y_path`` as .npy.  Port of
    ``_embed_brennan_audio`` (JAX ``cli/train_speech.py:212-257``): the
    ``.wav`` files under ``{root_dir}/data/Brennan2018/audio``, in name
    order, concatenated and brought to ``preprocs.audio_resample_rate``;
    the encoder from ``wav2vec_model`` with ``wav2vec_backend`` (default
    ``auto``).  Returns the (F, T) stream on ``device``."""
    dev = resolve_device(device)
    pre = cfg.preprocs
    audio_dir = os.path.join(cfg.get("root_dir", "."), "data", "Brennan2018",
                             "audio")
    paths = sorted(glob.glob(os.path.join(audio_dir, "*.wav")))
    if not paths:
        raise FileNotFoundError(f"no audio under {audio_dir}")
    rates, wavs = zip(*(wav2vec.read_wav(p) for p in paths))
    if len(set(rates)) != 1:
        raise ValueError(f"the audio files have several sample rates: {rates}")
    wav = torch.from_numpy(np.concatenate(wavs)).to(dev)
    target = int(pre.get("audio_resample_rate", 16000))
    if rates[0] != target:
        wav = resample_fft(wav[None], down=rates[0] / target)[0]
    model = wav2vec.load_wav2vec(
        cfg.get("wav2vec_model") or "facebook/wav2vec2-large-xlsr-53",
        backend=cfg.get("wav2vec_backend", "auto"), device=dev)
    if pre.get("last4layers", True):
        emb = wav2vec.embed_last4_avg(model, wav)
    else:
        emb = wav2vec.embed_features(model, wav)
    del model
    # resample embeddings to the brain rate (~50 → 120 Hz; the reference
    # hard-codes up=2.4, brennan2018.py:197-201 — computed here)
    emb_rate = emb.shape[-1] / (wav.shape[0] / target)
    emb = resample_fft(emb, up=float(pre.brain_resample_rate) / emb_rate)
    os.makedirs(os.path.dirname(y_path) or ".", exist_ok=True)
    np.save(y_path, emb.cpu().numpy())
    return emb
