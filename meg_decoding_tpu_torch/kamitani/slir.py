"""SLiR — ARD-style sparse linear regression (Kamitani-lab baseline).
Port of ``meg_decoding_tpu/kamitani/slir.py`` (``:29-149``).

Reference: ``meg_decoding/kamitani_lab/slir.py`` (a vendored copy of the
public KamitaniLab/slir): iterative ARD updates
``A ← sqrt(A · (WW/SY) / (G_A · L))`` with noise-variance re-estimation
and dimension pruning.

As in the JAX package, the fit keeps static shapes and prunes by a
persistent mask (pruned features contribute nothing), and it runs on a
batch of independent problems at once — JAX ``vmap``s it over the output
units, here the units are a leading batch axis of every tensor.  Each
iteration is a few batched matmuls and one batched pseudo-inverse on the
device (``torch.linalg.pinv``, f32, with JAX's cutoff of 10·max(M, N)·eps
of the working type relative to the largest singular value).  G + I is symmetric positive
definite, so a Cholesky solve is the same mathematics; the pinv follows
JAX's rounding.  No Pallas kernel lies here: library linear algebra is the
route on both sides.
"""

from __future__ import annotations

import numpy as np
import torch

from meg_decoding_tpu_torch.device import resolve_device

__all__ = ["slir_fit", "slir_predict", "SparseLinearRegression"]


def _pinv(a: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[-2:])
    return torch.linalg.pinv(a, rtol=10.0 * n * torch.finfo(a.dtype).eps)


@torch.no_grad()
def slir_fit(X, Y, n_iter: int = 200, minval: float = 1e-15,
             prune_mode: int = 1, prune_threshold: float = 1e-10,
             device: str | torch.device | None = None,
             dtype: torch.dtype = torch.float32):
    """ARD regression with masked pruning.

    X: (…, N, D) features; Y: (…, N, L) targets (tensors or numpy; the
    leading axes, if any, are independent problems).  Returns
    ``(W (…, L, D), A (…, D), SY (…,), mask (…, D) bool)`` on ``device``
    (X's when None): the reference's update equations with pruning as a
    persistent mask (dimensions whose relative alpha, or relative weight
    for ``prune_mode`` 2, falls to ``prune_threshold`` are frozen out;
    ``prune_mode`` 0 prunes nothing).  The primal (D×D) branch when
    N ≥ D, the dual (N×N, Woodbury) branch when N < D.  ``dtype`` is the
    working precision: float32 as JAX's fit, float64 for a reference run
    without its rounding."""
    dev = resolve_device(device) if device is not None else (
        X.device if torch.is_tensor(X) else torch.device("cpu"))
    X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                        dtype=dtype, device=dev).transpose(-1, -2)
    Y = torch.as_tensor(np.asarray(Y) if not torch.is_tensor(Y) else Y,
                        dtype=dtype, device=dev).transpose(-1, -2)
    D, N = X.shape[-2:]
    L = Y.shape[-2]
    Xt = X.transpose(-1, -2)                                  # (…, N, D)

    X_var = (X * X).mean(dim=-1)                              # (…, D)
    SY0 = (Y * Y).mean(dim=-1).mean(dim=-1)                   # (…,)
    alpha0 = torch.clamp(1.0 / X_var.mean(dim=-1), min=minval)
    A = alpha0[..., None].expand(*X_var.shape).clone()
    mask = torch.ones_like(A, dtype=torch.bool)
    YX = Y @ Xt                                               # (…, L, D)
    sumYY = (Y * Y).sum(dim=(-1, -2))
    use_dual = N < D
    XXT = None if use_dual else X @ Xt                        # (…, D, D)
    eye = torch.eye(N if use_dual else D, dtype=dtype, device=dev)

    def solve(Am):
        """Posterior weights and gains for prior variances Am (pruned
        dimensions 0); the primal form with symmetric √A scaling."""
        if use_dual:
            XA = Xt * Am[..., None, :]                        # (…, N, D)
            XC = X @ _pinv(XA @ X + eye)                      # (…, D, N)
            W = YX * Am[..., None, :]
            W = W - (W @ XC) @ XA                             # (…, L, D)
            G_A = Am * (X * XC).sum(dim=-1)
        else:
            s = torch.sqrt(Am)
            G = (s[..., :, None] * XXT) * s[..., None, :]
            inv = _pinv(G + eye)
            W = ((YX * s[..., None, :]) @ inv) * s[..., None, :]
            G_A = (G * inv.transpose(-1, -2)).sum(dim=-1)     # diag(G @ inv)
        return W, G_A

    SY = SY0
    for _ in range(n_iter):
        Am = torch.where(mask, A, 0.0)
        W, G_A = solve(Am)
        WW = (W * W).sum(dim=-2)                              # (…, D)
        SY = (sumYY - (W * YX).sum(dim=(-1, -2))) / (L * N)
        # reference slir.py:177-183: when the quick noise estimate
        # collapses, re-estimate from the residuals and the weight penalty
        resid = Y - W @ X
        penalty = torch.where(mask, WW / torch.clamp(A, min=minval), 0.0).sum(dim=-1)
        SY_fallback = ((resid * resid).sum(dim=(-1, -2)) + penalty) / (L * N)
        SY = torch.where(SY / SY0 < 1e-6, torch.clamp(SY_fallback, min=minval), SY)
        G_A = torch.clamp(G_A, min=minval)
        A_new = torch.sqrt(torch.clamp(A, min=minval) * (WW / SY[..., None])
                           / (G_A * L))
        A_new = torch.clamp(torch.where(mask, A_new, 0.0), max=1e8)
        if prune_mode > 0:
            ref = A_new if prune_mode == 1 else WW
            rel = ref / torch.clamp(ref.amax(dim=-1, keepdim=True), min=minval)
            new_mask = mask & (rel > prune_threshold)
            # never prune everything
            mask = torch.where(new_mask.any(dim=-1, keepdim=True), new_mask, mask)
        A = torch.clamp(A_new, min=0.0)

    Am = torch.where(mask, A, 0.0)
    W, _ = solve(Am)
    return W, Am, SY, mask


def slir_predict(W: torch.Tensor, X) -> torch.Tensor:
    """(…, L, D) weights × (…, N, D) features → (…, N, L) predictions."""
    X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X,
                        dtype=torch.float32, device=W.device)
    return X @ W.transpose(-1, -2)


class SparseLinearRegression:
    """sklearn-style wrapper over ``slir_fit`` (the reference's estimator
    API, ``slir.py:12-276``)."""

    def __init__(self, n_iter=200, minval=1.0e-15, prune_mode=1,
                 prune_threshold=1.0e-10, verbose=False,
                 device: str | torch.device = "cuda"):
        self.n_iter = n_iter
        self.minval = minval
        self.prune_mode = prune_mode
        self.prune_threshold = prune_threshold
        self.verbose = verbose
        self.device = device

    def fit(self, X, y):
        y = np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        W, A, SY, mask = slir_fit(
            np.asarray(X), y, n_iter=self.n_iter, minval=self.minval,
            prune_mode=self.prune_mode, prune_threshold=self.prune_threshold,
            device=self.device)
        self._W = W
        self.coef_ = W.cpu().numpy().squeeze()
        self.lambda_ = A.cpu().numpy()
        self.alpha_ = float(SY)
        self.valid_index_list = np.where(mask.cpu().numpy())[0]
        return self

    def predict(self, X):
        C = slir_predict(self._W, np.asarray(X)).cpu().numpy()
        return C.flatten() if C.shape[1] == 1 else C
