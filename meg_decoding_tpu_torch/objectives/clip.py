"""CLIP-style symmetric InfoNCE loss with a temperature.
Port of ``meg_decoding_tpu/objectives/clip.py``.

Reference: ``meg_decoding/utils/loss.py:55-112`` (``CLIPLoss``): L2-normalize
x and y, ``logits = x @ y.T * exp(temp)``, then
``(CE(logits, arange) + CE(logits.T, arange)) / 2``.

Under data parallelism (``clip_loss_sharded``, JAX ``:115-270``) each rank
holds (B_local, …) rows of x and y.  Only **y** is all-gathered: the local
rows ``x_local @ y_allᵀ`` are this rank's row-block of the global logits,
CE(x→y) comes from them, and CE(y→x) needs the global matrix's columns,
rebuilt from a MAX all-reduce of the stop-gradient column max and a SUM
all-reduce of the column sums of exp.  Each rank's returned loss is its
SHARE of the global loss (its rows' terms over B_global): the shares sum
to the global loss, the collectives' backwards SUM, and the trainer SUM
all-reduces the parameter gradients (``train/steps.py``).
"""

from __future__ import annotations

import torch

__all__ = ["clip_loss", "clip_logits", "clip_loss_local_rows",
           "clip_loss_local_rows_gathered", "clip_loss_sharded"]

EPS = 1e-12


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """L2-normalize over every non-batch axis, in f32, rounded once back to
    the input dtype.  The epsilon clamps the sum of squares INSIDE the sqrt
    (a zero row then has a finite gradient)."""
    axes = tuple(range(1, v.dim()))
    v32 = v.to(torch.float32)
    norm = torch.sqrt(torch.clamp((v32 * v32).sum(dim=axes, keepdim=True),
                                  min=EPS * EPS))
    return (v32 / norm).to(v.dtype)


def _row_norms(v: torch.Tensor) -> torch.Tensor:
    """Per-row L2 norm over every non-batch axis, (B, ...) → (B,) in f32,
    with the same epsilon placement as ``_normalize``."""
    axes = tuple(range(1, v.dim()))
    v32 = v.to(torch.float32)
    return torch.sqrt(torch.clamp((v32 * v32).sum(dim=axes), min=EPS * EPS))


def _cosine_logits(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, ...) × (B, ...) → (B, B) contracting all non-batch axes, f32."""
    return torch.matmul(x.reshape(x.shape[0], -1).to(torch.float32),
                        y.reshape(y.shape[0], -1).to(torch.float32).T)


def clip_logits(x: torch.Tensor, y: torch.Tensor, temp: torch.Tensor,
                impl: str = "factored") -> torch.Tensor:
    """Temperature-scaled cosine-similarity logits (B, B).

    ``'factored'``: dot the raw embeddings and rescale the (B, B) logits by
    the outer product of inverse row norms.  ``'normalized'``: normalize,
    then dot (the reference's op order)."""
    if impl == "factored":
        g = _cosine_logits(x, y)
        inv = torch.exp(temp) / (_row_norms(x)[:, None] * _row_norms(y)[None, :])
        return g * inv
    if impl == "normalized":
        return _cosine_logits(_normalize(x), _normalize(y)) * torch.exp(temp)
    raise ValueError(f"unknown clip_logits impl {impl!r}")


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   reduction: str) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, targets[:, None])[:, 0]
    return nll.mean() if reduction == "mean" else nll.sum()


def clip_loss(x, y, temp, reduction: str = "mean", return_logits: bool = False,
              impl: str = "factored"):
    """Symmetric InfoNCE over the batch.  x, y: (B, ...)."""
    logits = clip_logits(x, y, temp, impl=impl)
    targets = torch.arange(logits.shape[0], device=logits.device)
    loss = (_cross_entropy(logits, targets, reduction)
            + _cross_entropy(logits.T, targets, reduction)) / 2.0
    if return_logits:
        return logits, loss
    return loss


def _local_row_topk_hits(logits_rows: torch.Tensor, local_targets: torch.Tensor,
                         top_ks) -> dict:
    """Hit counts from this rank's rows of the global logits: is each
    row's own (global) column among its k best?  SUM all-reduced and
    divided by B_global they are ``retrieval_accuracy_from_sim`` of the
    full matrix."""
    logits_rows = logits_rows.detach()
    hits = {}
    for k in top_ks:
        if k == 1:
            h = logits_rows.argmax(dim=1) == local_targets
        else:
            kk = min(k, logits_rows.shape[1])
            top_idx = torch.topk(logits_rows, kk, dim=1).indices
            h = (top_idx == local_targets[:, None]).any(dim=-1)
        hits[f"top{k}"] = h.to(torch.float32).sum()
    return hits


def _metrics(mesh, share: torch.Tensor, hits: dict, b_global: int) -> dict:
    """One SUM all-reduce of the detached loss share and the hit counts:
    the global loss and the top-k accuracies, the same on every rank."""
    keys = list(hits)
    buf = mesh.all_reduce_(torch.stack([share.detach(), *hits.values()]))
    return {"loss": buf[0],
            **{k: buf[1 + i] / b_global for i, k in enumerate(keys)}}


def clip_loss_sharded(x_local, y_local, temp, mesh, reduction: str = "mean",
                      top_ks=None, impl: str = "factored"):
    """This rank's share of the CLIP loss over a batch split across the
    ranks of ``mesh`` (JAX ``clip_loss_sharded``, which wraps
    ``clip_loss_local_rows`` in ``shard_map``; here every process already
    holds its own rows, so the two are one function).  x_local, y_local:
    (B_local, …), the same B_local on every rank; ``mesh`` a
    ``core/mesh.py:DataMesh``.

    Returns the share, differentiable wrt x_local, y_local (through the
    all-gather of y) and temp; with ``top_ks`` (e.g. (1, 10)),
    ``(share, metrics)``: ``metrics['loss']`` the global loss and
    ``metrics['top{k}']`` the retrieval accuracies of the global matrix,
    detached and the same on every rank.  ``impl`` as ``clip_logits``:
    'normalized' gathers normalized rows."""
    n, b_local = mesh.world_size, x_local.shape[0]
    x_local = x_local.reshape(b_local, -1)
    y_local = y_local.reshape(b_local, -1)
    if impl == "normalized":
        x_local, y_local = _normalize(x_local), _normalize(y_local)
    elif impl != "factored":
        raise ValueError(f"unknown clip_logits impl {impl!r}")
    y_all = mesh.all_gather(y_local)  # (B_global, F)

    scale = torch.exp(temp)
    start = mesh.rank * b_local
    local_targets = start + torch.arange(b_local, device=x_local.device)
    if impl == "normalized":
        inv = scale
    else:
        inv = scale / (_row_norms(x_local)[:, None] * _row_norms(y_all)[None, :])
    logits_xy = torch.matmul(x_local.to(torch.float32),
                             y_all.to(torch.float32).T) * inv

    ce_xy = _cross_entropy(logits_xy, local_targets, "sum")
    # CE(y→x) from the columns: a global per-column logsumexp assembled
    # from every rank's row-block (the max is a stop-gradient shift)
    col_max = mesh.all_reduce_(logits_xy.detach().amax(dim=0), "max")
    col_sum = mesh.all_reduce(torch.exp(logits_xy - col_max[None, :]).sum(dim=0))
    col_lse = col_max + torch.log(col_sum)
    diag = logits_xy.gather(1, local_targets[:, None])[:, 0]
    ce_yx = (col_lse[start:start + b_local] - diag).sum()

    share = (ce_xy + ce_yx) / 2.0
    if reduction == "mean":
        share = share / (b_local * n)
    if top_ks is None:
        return share
    hits = _local_row_topk_hits(logits_xy, local_targets, top_ks)
    return share, _metrics(mesh, share, hits, b_local * n)


clip_loss_local_rows = clip_loss_sharded  # JAX's name for the per-shard body


def clip_loss_local_rows_gathered(x_local, y_local, temp, mesh,
                                  reduction: str = "mean"):
    """The both-gather variant (all-gather x AND y, two (B_local,
    B_global) matmuls), kept as the comparison baseline of
    ``clip_loss_sharded``; returns this rank's share."""
    n, b_local = mesh.world_size, x_local.shape[0]
    x_local = _normalize(x_local.reshape(b_local, -1))
    y_local = _normalize(y_local.reshape(b_local, -1))
    x_all = mesh.all_gather(x_local)
    y_all = mesh.all_gather(y_local)
    scale = torch.exp(temp)
    local_targets = mesh.rank * b_local + torch.arange(b_local,
                                                       device=x_local.device)
    f32 = torch.float32
    logits_xy = torch.matmul(x_local.to(f32), y_all.to(f32).T) * scale
    logits_yx = torch.matmul(y_local.to(f32), x_all.to(f32).T) * scale
    share = (_cross_entropy(logits_xy, local_targets, "sum")
             + _cross_entropy(logits_yx, local_targets, "sum")) / 2.0
    if reduction == "mean":
        share = share / (b_local * n)
    return share
