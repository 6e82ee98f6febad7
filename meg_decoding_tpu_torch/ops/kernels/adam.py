"""Adam's update of a whole parameter list: the multi-tensor CUDA kernel
``csrc/adam.cu`` and its plain PyTorch version.

``adam_update(params, grads, mus, nus, neg_lr, c1, c2, ok)`` updates each
parameter and its moments in place, as ``optax.scale_by_adam`` and
``scale_by_learning_rate`` order the arithmetic (``train/optim.py``):

  mu' = (1−b1)·g + b1·mu,  nu' = (1−b2)·(g·g) + b2·nu,
  p'  = p + (mu'/c1) / (√(nu'/c2) + eps) · neg_lr,

and keeps p', mu' and nu' only where ``ok``.  A gradient of None counts as
zeros.  ``neg_lr`` (−lr), ``c1`` and ``c2`` (the bias corrections 1 − b^t)
are 0-dim f32 tensors and ``ok`` a 0-dim bool, all on the parameters'
device: nothing is read back to the host.

This kernel replaces no Pallas kernel: the JAX package runs
``optax.adam``, which XLA fuses.  The plain version is the eager op chain
the port ran before the kernel, ~19 operations a parameter.

Route, by the device: on the card every list goes to the kernel, one
launch per slice of ``MAX_TENSORS`` tensors (``plan``); on the CPU the
plain chain runs.  On the card a strided gradient is read through a
contiguous copy, and a parameter or moment that is not a contiguous f32
tensor on that card, a gradient of another dtype or device, or scalars
that are not 0-dim f32 (``ok`` bool) there raise a ValueError: a layout
mistake fails loudly instead of running the chain unseen.  The kernel's
p, mu and nu are bit-identical to the chain's on the card: the same f32
constants, which the wrapper passes to the launch, and the same roundings
in the same order.  ``launches`` counts kernel launches
(``multi_tensor``) and calls of the chain (``eager``).
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["B1", "B2", "EPS", "CHUNK", "MAX_TENSORS", "plan", "card_lists",
           "adam_update", "adam_update_plain", "launches", "reset_launches"]

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults, the JAX trainer's

# elements a CTA updates, and tensors a launch's table holds (csrc/adam.cu's
# kChunk and kMaxTensors; the launcher refuses another chunk size)
CHUNK = 1024
MAX_TENSORS = 88
_MAX_CHUNKS = 2**31 - 1  # the grid, and the int32 prefix sums

# kernel launches and eager-chain calls since the last reset_launches() (a
# replay of a captured train step adds what its capture counted,
# train/graph.py)
launches = {"multi_tensor": 0, "eager": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def plan(numels) -> list:
    """The launches for tensors of ``numels`` elements: ``[(lo, hi,
    starts)]``, one per slice ``[lo, hi)`` of at most ``MAX_TENSORS``
    tensors, ``starts`` the slice's ``hi − lo + 1`` prefix sums of
    ``⌈numel / CHUNK⌉`` (tensor i's first chunk; the last is the grid)."""
    out = []
    for lo in range(0, len(numels), MAX_TENSORS):
        starts = [0]
        for n in numels[lo:lo + MAX_TENSORS]:
            if n < 0:
                raise ValueError(f"numel {n} < 0")
            starts.append(starts[-1] + -(-int(n) // CHUNK))
        if starts[-1] > _MAX_CHUNKS:
            raise ValueError(f"{starts[-1]} chunks exceed the grid's "
                             f"{_MAX_CHUNKS}")
        out.append((lo, lo + len(starts) - 1, starts))
    return out


def adam_update_plain(params, grads, mus, nus, neg_lr, c1, c2, ok) -> None:
    """The eager op chain: each parameter's update as ~19 PyTorch ops."""
    for p, g, mu, nu in zip(params, grads, mus, nus):
        if g is None:
            g = torch.zeros_like(p)
        mu_new = (1 - B1) * g + B1 * mu
        nu_new = (1 - B2) * (g * g) + B2 * nu
        u = (mu_new / c1) / (torch.sqrt(nu_new / c2) + EPS)
        p.copy_(torch.where(ok, p + u * neg_lr, p))
        mu.copy_(torch.where(ok, mu_new, mu))
        nu.copy_(torch.where(ok, nu_new, nu))


def _check_sizes(params, grads, mus, nus) -> None:
    if not len(params) == len(grads) == len(mus) == len(nus):
        raise ValueError("adam_update: lists of different lengths")
    for p, g, mu, nu in zip(params, grads, mus, nus):
        n = p.numel()
        if any(t is not None and t.numel() != n for t in (g, mu, nu)):
            raise ValueError("adam_update: a gradient or moment differs in "
                             "size from its parameter")


def card_lists(params, grads, mus, nus, scalars, dev) -> list:
    """The gradients as the kernel reads them on ``dev``: a strided one as
    a contiguous copy.  Raises a ValueError for a parameter or moment that
    is not a contiguous f32 tensor on ``dev``, a gradient of another dtype
    or device, or scalars that are not 0-dim f32 (``ok`` bool) on
    ``dev``."""
    for t in (*params, *mus, *nus):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                "adam_update: a parameter or moment is not a contiguous f32 "
                f"tensor on {dev} ({t.dtype}, {t.device}, stride "
                f"{t.stride()})")
    for g in grads:
        if g is not None and (g.device != dev or g.dtype != torch.float32):
            raise ValueError(f"adam_update: a gradient of {g.dtype} on "
                             f"{g.device}, not f32 on {dev}")
    for s, want in zip(scalars, (torch.float32,) * 3 + (torch.bool,)):
        if not (isinstance(s, torch.Tensor) and s.device == dev
                and s.dim() == 0 and s.dtype == want):
            raise ValueError(
                "adam_update: neg_lr, c1, c2 and ok are 0-dim f32, f32, f32 "
                f"and bool tensors on {dev}; got {s!r}")
    return [g if g is None or g.is_contiguous() else g.contiguous()
            for g in grads]


_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the chain's constants as the launch takes them, each rounded to f32 as
# torch rounds a Python float that multiplies an f32 tensor
_CONSTS = (1 - B1, B1, 1 - B2, B2, EPS)
_FN = []


def _fn():
    if not _FN:
        from meg_decoding_tpu_torch.ops.kernels.build import load_library

        fn = load_library("adam").adam_multi_tensor_launch
        fn.restype = _INT
        fn.argtypes = ([_INT] + [ctypes.POINTER(_PTR)] * 4
                       + [ctypes.POINTER(_I64), ctypes.POINTER(ctypes.c_int32),
                          _I64] + [ctypes.c_float] * 5 + [_PTR] * 5)
        _FN.append(fn)
    return _FN[0]


def _launch(params, grads, mus, nus, neg_lr, c1, c2, ok, stream) -> None:
    """One launch per slice of ``plan`` on ``stream`` (a raw CUDA stream)."""
    scalars = [t.data_ptr() for t in (neg_lr, c1, c2, ok)]
    for lo, hi, starts in plan([p.numel() for p in params]):
        if starts[-1] == 0:
            continue
        n = hi - lo
        ptrs = [(_PTR * n)(*(t.data_ptr() if t is not None else None
                             for t in ts[lo:hi]))
                for ts in (params, grads, mus, nus)]
        err = _fn()(n, *ptrs,
                    (_I64 * n)(*(p.numel() for p in params[lo:hi])),
                    (ctypes.c_int32 * (n + 1))(*starts), CHUNK, *_CONSTS,
                    *scalars, stream)
        if err != 0:
            raise RuntimeError("adam_multi_tensor kernel launch failed: CUDA "
                               f"error {err}")
        launches["multi_tensor"] += 1


@torch.no_grad()
def adam_update(params, grads, mus, nus, neg_lr, c1, c2, ok) -> None:
    """One Adam step over the lists (module docstring), in place: the
    kernel on the card, the plain chain on the CPU."""
    _check_sizes(params, grads, mus, nus)
    if not params:
        return
    dev = params[0].device
    if dev.type == "cuda":
        grads = card_lists(params, grads, mus, nus, (neg_lr, c1, c2, ok), dev)
        _launch(params, grads, mus, nus, neg_lr, c1, c2, ok,
                torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        adam_update_plain(params, grads, mus, nus, neg_lr, c1, c2, ok)
        launches["eager"] += 1
