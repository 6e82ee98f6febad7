"""Adam with an update that a non-finite step leaves undone, on the device.

The JAX package trains with ``optax.adam(schedule)`` and keeps params,
optimizer state and BN statistics of a step whose loss or gradient norm is
not finite (``train/steps.py:214-225``).  This is that optimizer, written
out so the port can do the same without a host sync:

* ``optax.scale_by_adam``'s formula and order: ``mu = (1−b1)·g + b1·mu``,
  ``nu = (1−b2)·g² + b2·nu``, ``count += 1``, ``mu_hat = mu/(1 − b1^count)``,
  ``nu_hat = nu/(1 − b2^count)``, ``u = mu_hat/(√nu_hat + eps)``, with
  optax's defaults b1 0.9, b2 0.999, eps 1e-8 and eps_root 0; then
  ``scale_by_learning_rate``: ``p += −lr(count_before)·u``;
* every new value is written as ``torch.where(ok, new, old)``, with ``ok``
  a 0-dim bool tensor on the device.

The update of the whole list is ``ops/kernels/adam.py:adam_update``: one
multi-tensor CUDA kernel on the card, which takes f32 tensors (every
configuration's) and refuses others, bit-identical to the eager op chain
that runs on the CPU.  The learning rate, the bias corrections and the
count stay a few 0-dim tensor ops here.

``torch.optim.Adam`` does not fit: it cannot skip a step on the device
without a sync, and it applies the bias correction in another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from meg_decoding_tpu_torch.ops.kernels.adam import B1, B2, adam_update
from meg_decoding_tpu_torch.utils.profiling import scope

__all__ = ["AdamState", "Adam", "global_norm"]


@dataclass
class AdamState:
    """First and second moments per parameter name, and the count of
    updates applied (0-dim int32 on the parameters' device)."""
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    count: torch.Tensor


def global_norm(grads) -> torch.Tensor:
    """√(Σ‖g‖²) over the gradients that are not None (``optax.global_norm``)."""
    return torch.sqrt(sum((g * g).sum() for g in grads if g is not None))


class Adam:
    """``optax.adam`` with ``schedule(count) → lr`` as its learning rate."""

    def __init__(self, schedule: Callable[[torch.Tensor], torch.Tensor]):
        self.schedule = schedule

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        device = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in params.items()}
        return AdamState(mu=zeros(), nu=zeros(),
                         count=torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def update(self, params: dict[str, torch.Tensor],
               grads: dict[str, torch.Tensor | None], state: AdamState,
               ok: torch.Tensor) -> None:
        """One Adam step, in place, where ``ok``; a gradient of None counts
        as zeros (a parameter the loss does not reach).  The scope ``adam``
        of a captured body (``utils/profiling.py``)."""
        with scope("adam"):
            self._update(params, grads, state, ok)

    def _update(self, params, grads, state: AdamState, ok) -> None:
        neg_lr = -self.schedule(state.count)
        count_inc = state.count + 1
        c1 = 1 - B1 ** count_inc.to(torch.float32)
        c2 = 1 - B2 ** count_inc.to(torch.float32)
        names = list(params)
        adam_update([params[k] for k in names], [grads.get(k) for k in names],
                    [state.mu[k] for k in names], [state.nu[k] for k in names],
                    neg_lr, c1, c2, ok)
        state.count.copy_(torch.where(ok, count_inc, state.count))
