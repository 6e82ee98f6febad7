"""The fused Gwilliams train step and the whole-epoch forms.  Port of the
single-device branches of ``make_fused_speech_step``, ``make_scan_epoch``
and ``make_gwilliams_scan_epoch`` in ``meg_decoding_tpu/train/scan_loop.py``
(``:182-464``).

In JAX the gather and the step compile into one program to save a
dispatch; PyTorch runs eagerly, so here the fused step is the gather
(``gather_speech_batch``: two launches of the ``window_gather`` kernel)
followed by ``make_train_step``'s step.

With ``cache_collate_stats`` the fused and the epoch forms sweep every
window's RobustScaler fit once (``data/gwilliams.py:compute_collate_stats``)
and each step gathers its (B, 2C) rows of that table in place of the
percentiles (``collate_preprocess_cached``).

JAX runs a whole epoch as one ``lax.scan`` program.  PyTorch has no scan,
so an epoch here is an eager loop over ``updates`` steps: every draw of the
epoch (the (updates, B) segment ids, with replacement whatever
``use_sampler`` says, and, for Gwilliams, the (updates, B) sessions) is
made up front on the device from one ``torch.Generator``, each step's
batch is gathered on the device, nothing in the loop waits for the device,
and the metrics are averaged on the device (``epoch_means``); the caller
reads them once.

Under a data-parallel ``mesh`` (``core/mesh.py``; JAX ``:40-180`` and the
``mesh=`` branches) the Gwilliams recordings are sharded over sessions
(``shard_gwilliams_splits``), each rank gathers its rows of every global
batch from its own shard (``_make_sharded_gather``), and the step is
``make_train_step(mesh=)``'s.  Every draw is of the global batch — the
segment ids and the shard-local sessions — made alike on every rank from
its copy of one seeded generator; each rank takes its rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from meg_decoding_tpu_torch.core.mesh import local_batch_size
from meg_decoding_tpu_torch.data.gwilliams import (
    GwilliamsPacked,
    _gather_batch,
    collate_stats_rows,
    compute_collate_stats,
    draw_local_sessions,
    draw_sessions,
    gather_speech_batch,
    local_shard_gather,
)
from meg_decoding_tpu_torch.train.optim import Adam
from meg_decoding_tpu_torch.train.steps import (
    CollateConfig,
    LossConfig,
    make_train_step,
)

__all__ = ["make_fused_speech_step", "make_scan_epoch",
           "make_gwilliams_scan_epoch", "epoch_means",
           "shard_gwilliams_splits", "is_session_sharded"]


def is_session_sharded(ds: GwilliamsPacked, mesh) -> bool:
    """True when ``ds`` already holds this rank's session shard of
    ``mesh`` (``shard_gwilliams_splits`` ran on it)."""
    return ds.session_shard == (mesh.rank, mesh.world_size)


def shard_gwilliams_splits(mesh, *splits: GwilliamsPacked):
    """This rank's session shard of one or more splits (JAX ``:53-118``):
    sessions padded cyclically to a multiple of the world size
    (``pad_sessions``), rows [r·S_local, (r+1)·S_local) of the recordings
    and meg_onsets moved to the rank's device, the streams, speech onsets
    and the padded session table whole.  Only the shard is copied to the
    device, so a split built on the host never has to fit one card.

    Splits that alias one tensor (sentence and deep splits share the
    recordings, the streams and the session table) share its sharded copy:
    each source tensor is staged once.  Returns the sharded splits in
    order."""
    n, r = mesh.world_size, mesh.rank
    S = splits[0].num_sessions
    S_local = -(-S // n)
    take = np.concatenate([np.arange(S), np.arange(S_local * n - S) % S])
    staged = {}

    def put(t: torch.Tensor, rows) -> torch.Tensor:
        key = (str(t.device), t.untyped_storage().data_ptr(),
               t.storage_offset(), tuple(t.shape),
               None if rows is None else rows.tobytes())
        if key not in staged:
            part = t if rows is None else t.index_select(
                0, torch.from_numpy(rows).to(t.device))
            staged[key] = part.to(mesh.device)
        return staged[key]

    mine = take[r * S_local:(r + 1) * S_local]
    out = []
    for ds in splits:
        if ds.num_sessions != S or ds.session_shard is not None:
            raise ValueError("splits must share their (unsharded) sessions")
        out.append(dataclasses.replace(
            ds, recordings=put(ds.recordings, mine),
            meg_onsets=put(ds.meg_onsets, mine),
            y_stream=put(ds.y_stream, None),
            speech_onsets=put(ds.speech_onsets, None),
            session_subject=put(ds.session_subject, take),
            host_resident=False, session_shard=(r, n)))
    return tuple(out)


def _shard_gwilliams(ds: GwilliamsPacked, mesh) -> GwilliamsPacked:
    return ds if is_session_sharded(ds, mesh) else shard_gwilliams_splits(mesh, ds)[0]


def _make_sharded_gather(mesh, ds: GwilliamsPacked, y_dtype=None, stats=None):
    """``gather(idx, sess) → (X, Y, subject_idxs[, stats rows])``: this
    rank's rows of a global batch of segment ids ``idx`` (B,) and of its
    shard-local sessions ``sess`` (B,), gathered from the rank's shard of
    the session-sharded ``ds`` (``local_shard_gather``); with ``stats``
    (the shard's collate-stats table) the rows' statistics too."""
    dev = ds.recordings.device
    seg = torch.as_tensor(ds.segment_table(), device=dev)

    def gather(idx, sess):
        b = local_batch_size(len(idx), mesh)
        rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
        idx_l = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx)
                                else idx)[rows].to(dev, torch.int64)
        sess_l = torch.as_tensor(sess)[rows].to(dev, torch.int64)
        return local_shard_gather(
            idx_l, sess_l, ds.recordings, ds.meg_onsets, ds.y_stream,
            ds.speech_onsets, ds.session_subject, seg, int(ds.seq_len),
            mesh.rank, y_dtype=y_dtype, stats_local=stats)

    return gather


def _loss_y_dtype(model, loss_cfg: LossConfig):
    """Gather-time dtype of the Y windows: bf16 when the encoder computes
    in bf16 under the CLIP loss (the JAX package's PARITY deviation 15,
    symmetric with a bf16 Z), else None (Y's own f32)."""
    if loss_cfg.kind == "clip" and getattr(model, "dtype", None) == torch.bfloat16:
        return torch.bfloat16
    return None


def _stats_table(ds: GwilliamsPacked, collate_cfg: CollateConfig,
                 cache_collate_stats: bool, collate_stats, mesh=None):
    """The collate-stats table the step reads, or None: ``collate_stats``
    when given (implies caching), else one sweep when asked for; never
    with the collate off."""
    if not collate_cfg.enabled:
        return None
    if collate_stats is not None:
        return collate_stats
    if cache_collate_stats:
        return compute_collate_stats(ds, collate_cfg.baseline_len_samp,
                                     mesh=mesh)
    return None


def make_fused_speech_step(model, optimizer: Adam, loss_cfg: LossConfig,
                           collate_cfg: CollateConfig, ds: GwilliamsPacked,
                           cache_collate_stats: bool = False,
                           collate_stats=None, mesh=None):
    """Returns ``fused(state, idx, generator=None, sess_ids=None,
    centre=None) → (state, metrics)``: ``idx`` (B,) global segment ids of
    ``ds``; one session per segment from ``sess_ids`` when given, else drawn
    with ``generator``; ``centre`` is the spatial-dropout centre, drawn from
    ``state.generator`` when None.

    ``cache_collate_stats``: sweep the table once here and collate each
    batch from its rows; ``collate_stats``: a table already computed for
    this dataset and baseline.  The table is ``fused.collate_stats``.

    With ``mesh``: ``ds`` is session-sharded here unless it already is
    (``fused.ds``), the table is the shard's, ``idx`` is the global batch
    and ``sess_ids`` (B,) its device-major shard-local sessions
    (``draw_local_sessions``, drawn with ``generator`` when None); each
    rank gathers and steps on its rows."""
    step = make_train_step(model, optimizer, loss_cfg, collate_cfg, mesh=mesh)
    y_dtype = _loss_y_dtype(model, loss_cfg)
    if mesh is not None:
        ds = _shard_gwilliams(ds, mesh)
        stats = _stats_table(ds, collate_cfg, cache_collate_stats,
                             collate_stats, mesh)
        gather = _make_sharded_gather(mesh, ds, y_dtype, stats)
        n_sessions = len(ds.session_subject)

        def fused_dp(state, idx, generator: torch.Generator | None = None,
                     sess_ids=None, centre: int | None = None):
            if sess_ids is None:
                if generator is None:
                    raise ValueError("pass sess_ids or a torch.Generator")
                sess_ids = draw_local_sessions(generator, len(idx),
                                               mesh.world_size, n_sessions)
            out = gather(idx, sess_ids)
            return step(state, *out[:3], centre=centre,
                        collate_stats=out[3] if len(out) == 4 else None)

        fused_dp.ds, fused_dp.collate_stats = ds, stats
        return fused_dp
    stats = _stats_table(ds, collate_cfg, cache_collate_stats, collate_stats)
    seg_dev = (torch.as_tensor(ds.segment_table(), device=ds.recordings.device)
               if stats is not None else None)

    def fused(state, idx, generator: torch.Generator | None = None,
              sess_ids=None, centre: int | None = None):
        if sess_ids is None:
            sess_ids = draw_sessions(ds, len(idx), generator)
        X, Y, subs, _ = gather_speech_batch(ds, idx, sess_ids=sess_ids,
                                            y_dtype=y_dtype)
        srows = None
        if stats is not None:
            rows = seg_dev[torch.as_tensor(idx, device=seg_dev.device)]
            sess = torch.as_tensor(sess_ids, dtype=torch.int64,
                                   device=seg_dev.device)
            srows = collate_stats_rows(ds, stats, rows[:, 0], rows[:, 1], sess)
        return step(state, X, Y, subs, centre=centre, collate_stats=srows)

    fused.collate_stats = stats
    return fused


def epoch_means(history: list[dict], updates: int) -> dict:
    """Per-epoch metric means on the device (``_build_epoch``, ``:314-322``):
    a step skipped by the non-finite guard carries metrics masked to 0, so
    every metric but ``temp`` and ``skipped`` is summed and divided by
    max(updates − Σ skipped, 1); those two take the plain mean."""
    cols = {k: torch.stack([h[k] for h in history]) for k in history[0]}
    if "skipped" not in cols:
        return {k: v.mean() for k, v in cols.items()}
    n_valid = torch.clamp(updates - cols["skipped"].sum(), min=1.0)
    return {k: (v.mean() if k in ("skipped", "temp") else v.sum() / n_valid)
            for k, v in cols.items()}


def _draw(generator, n: int, updates: int, batch_size: int, device):
    if generator is None:
        raise ValueError("pass the epoch's draws or a torch.Generator")
    return torch.randint(0, n, (updates, batch_size), generator=generator,
                         device=device)


def _rows(mesh, batch_size: int) -> slice:
    """This rank's columns of an (updates, B) draw; all of them alone."""
    if mesh is None:
        return slice(None)
    b = local_batch_size(batch_size, mesh)
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def make_scan_epoch(model, optimizer: Adam, loss_cfg: LossConfig,
                    collate_cfg: CollateConfig, dataset, updates: int,
                    batch_size: int, mesh=None):
    """The epoch over a ``PackedDataset`` on the device (GOD).  Returns
    ``epoch(state, generator=None, idx=None) → (state, means)``: ``idx``
    (updates, B) the epoch's indices, drawn with ``generator`` (a
    ``torch.Generator`` on the dataset's device) when None; ``means`` are
    0-dim tensors on the device (``epoch_means``).  With ``mesh`` every
    rank holds the whole dataset (GOD-sized sets have nothing to shard),
    ``idx`` is the global draw and each rank steps on its columns."""
    step = make_train_step(model, optimizer, loss_cfg, collate_cfg, mesh=mesh)
    dev = dataset.X.device
    mine = _rows(mesh, batch_size)

    def epoch(state, generator: torch.Generator | None = None, idx=None):
        if idx is None:
            idx = _draw(generator, len(dataset), updates, batch_size, dev)
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)[:, mine]
        history = []
        for u in range(idx.shape[0]):
            X, Y, subs = dataset.gather(idx[u])[:3]
            state, metrics = step(state, X, Y, subs)
            history.append(metrics)
        return state, epoch_means(history, idx.shape[0])

    return epoch


def make_gwilliams_scan_epoch(model, optimizer: Adam, loss_cfg: LossConfig,
                              collate_cfg: CollateConfig, ds: GwilliamsPacked,
                              updates: int, batch_size: int,
                              cache_collate_stats: bool = False, mesh=None):
    """The epoch over the packed Gwilliams split: each step pairs its
    segments with random sessions and gathers the windows on the device.
    Returns ``epoch(state, generator=None, idx=None, sess_ids=None) →
    (state, means)``: ``idx`` and ``sess_ids`` (updates, B), each drawn
    with ``generator`` (a ``torch.Generator`` on the dataset's device,
    segment ids first) when None.  ``cache_collate_stats`` as in
    ``make_fused_speech_step``; the table is ``epoch.collate_stats``.

    With ``mesh``: ``ds`` is session-sharded (``epoch.ds``), ``idx`` is
    the global draw and ``sess_ids`` the device-major shard-local sessions
    in [0, S_local); each rank gathers its columns from its shard."""
    step = make_train_step(model, optimizer, loss_cfg, collate_cfg, mesh=mesh)
    y_dtype = _loss_y_dtype(model, loss_cfg)
    if mesh is not None:
        n_segments = len(ds)
        ds = _shard_gwilliams(ds, mesh)
        stats = _stats_table(ds, collate_cfg, cache_collate_stats, None, mesh)
        gather = _make_sharded_gather(mesh, ds, y_dtype, stats)
        dev = ds.recordings.device
        S_local = ds.num_sessions

        def epoch_dp(state, generator: torch.Generator | None = None,
                     idx=None, sess_ids=None):
            if idx is None:
                idx = _draw(generator, n_segments, updates, batch_size, dev)
            if sess_ids is None:
                sess_ids = _draw(generator, S_local, *idx.shape, dev)
            history = []
            for u in range(len(idx)):
                out = gather(idx[u], sess_ids[u])
                state, metrics = step(state, *out[:3], collate_stats=(
                    out[3] if len(out) == 4 else None))
                history.append(metrics)
            return state, epoch_means(history, len(idx))

        epoch_dp.ds, epoch_dp.collate_stats = ds, stats
        return epoch_dp
    dev = ds.recordings.device
    seg_dev = torch.as_tensor(ds.segment_table(), device=dev)
    stats = _stats_table(ds, collate_cfg, cache_collate_stats, None)

    def epoch(state, generator: torch.Generator | None = None, idx=None,
              sess_ids=None):
        if idx is None:
            idx = _draw(generator, len(ds), updates, batch_size, dev)
        if sess_ids is None:
            sess_ids = _draw(generator, ds.num_sessions, *idx.shape, dev)
        idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
        sess_ids = torch.as_tensor(sess_ids, dtype=torch.int64, device=dev)
        history = []
        for u in range(idx.shape[0]):
            rows = seg_dev[idx[u]]
            X, Y, subs = _gather_batch(
                ds.recordings, ds.y_stream, ds.meg_onsets, ds.speech_onsets,
                ds.session_subject, rows[:, 0], rows[:, 1], sess_ids[u],
                ds.seq_len, y_dtype=y_dtype)
            srows = (None if stats is None else collate_stats_rows(
                ds, stats, rows[:, 0], rows[:, 1], sess_ids[u]))
            state, metrics = step(state, X, Y, subs, collate_stats=srows)
            history.append(metrics)
        return state, epoch_means(history, idx.shape[0])

    epoch.collate_stats = stats
    return epoch
