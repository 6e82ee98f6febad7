"""Training-mode BatchNorm kernels: the CUDA kernels
``csrc/batchnorm_stats.cu`` and their plain PyTorch versions.

Port of ``bn_stats`` and ``bn_bwd_stats`` from
``meg_decoding_tpu/ops/pallas/batchnorm.py``.  Training-mode BatchNorm
needs, per channel, (Σx, Σx²) in the forward and (Σg, Σg·x̂) in the
backward, with x̂ = (x − mean)·invstd, each in one read of its inputs and
accumulated in f32.  ``bn_bwd`` is the whole backward in one kernel: the
backward sums and, from them, the input gradient dx that the JAX custom
VJP computes after its Pallas kernel (``_bn_bwd``), reading g and x once.

The port's activations are NCW ``(B, C, T)``, so the channel is dim 1 and
the sums run over dims 0 and 2 (the JAX kernels take ``(M, C)`` with the
channel last).  Inputs are f32 or bf16; the sums are f32.

``bn_bwd_dx`` is that dx from sums and a count the caller gives: synced
BatchNorm under data parallelism all-reduces ``bn_bwd_stats``'s sums over
the ranks and takes dx from the global sums with M the global B·T
(``ops/batchnorm.py``), where the fused ``bn_bwd`` cannot serve (its dx
needs sums that are not yet global).

``bn_stats`` takes one of two routes of its kernel, picked by the
launcher from the channel count and a channel's size: a thread-block
cluster per channel (``cluster``: few long channels, as EEGNet's bn1
(64, 16, 528)) or one CTA per channel (``per_channel``: the speech step's
(64, 320, 360), GOD's (64, 320, 24) and every other shape).
``stats_route_launches`` counts the launches of each route, as the
launcher reports them.

``bn_stats``, ``bn_bwd_stats``, ``bn_bwd`` and ``bn_bwd_dx`` launch their kernel for a
CUDA tensor and run the plain version only for a CPU tensor.  The plain
versions are the ``'xla'`` branch math of the JAX package's ``_fwd_stats``
/ ``_bn_bwd``.  ``bn_bwd``'s launches count under ``"bn_bwd_stats"``: its
kernel is the one that replaces the Pallas ``bn_bwd_stats`` on the train
path.  ``sums_only_launches`` counts ``bn_bwd_stats``'s launches alone, so
that a caller can tell the two apart; ``dx_launches`` counts
``bn_bwd_dx``'s.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["bn_stats", "bn_stats_plain", "bn_bwd_stats", "bn_bwd_stats_plain",
           "bn_bwd", "bn_bwd_plain", "bn_bwd_dx", "bn_bwd_dx_plain",
           "STATS_ROUTES", "launches", "stats_route_launches",
           "sums_only_launches", "dx_launches", "reset_launches"]

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2**31 - 1

# bn_stats' routes, in the order of the kernel's route argument
STATS_ROUTES = ("per_channel", "cluster")

# kernel launches since the last reset_launches(), per kernel (a replay of a
# captured train step adds what its capture counted, train/graph.py)
launches = {"bn_stats": 0, "bn_bwd_stats": 0}
# of launches["bn_stats"], those of each route
stats_route_launches = dict.fromkeys(STATS_ROUTES, 0)
# of launches["bn_bwd_stats"], those of bn_bwd_stats (the sums without dx)
sums_only_launches = 0
# launches of bn_bwd_dx (dx from given sums: synced BatchNorm)
dx_launches = 0


def reset_launches() -> None:
    global sums_only_launches, dx_launches
    for counts in (launches, stats_route_launches):
        for k in counts:
            counts[k] = 0
    sums_only_launches = 0
    dx_launches = 0


def bn_stats_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T) → (Σx, Σx²) over dims 0 and 2, each (C,) f32."""
    xf = x.to(torch.float32)
    return xf.sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2))


def bn_bwd_stats_plain(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                       invstd: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) per channel of (B, C, T) inputs, each (C,) f32."""
    gf = g.to(torch.float32)
    xhat = (x.to(torch.float32) - mean[:, None]) * invstd[:, None]
    return gf.sum(dim=(0, 2)), (gf * xhat).sum(dim=(0, 2))


def bn_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 mean: torch.Tensor, invstd: torch.Tensor,
                 gmean: torch.Tensor | None = None,
                 gvar: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, Σg, Σg·x̂): the BatchNorm backward of (B, C, T) inputs, dx in
    x's dtype computed in f32, the sums (C,) f32.  gmean and gvar are the
    cotangents of the batch mean and variance, or None."""
    sg, sgx = bn_bwd_stats_plain(g, x, mean, invstd)
    dx = bn_bwd_dx_plain(g, x, scale, mean, invstd, torch.stack([sg, sgx]),
                         x.numel() // x.shape[1], gmean, gvar)
    return dx, sg, sgx


def bn_bwd_dx_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    mean: torch.Tensor, invstd: torch.Tensor,
                    sums: torch.Tensor, M: int,
                    gmean: torch.Tensor | None = None,
                    gvar: torch.Tensor | None = None) -> torch.Tensor:
    """dx of the BatchNorm backward from given sums (2, C) = [Σg, Σg·x̂]
    over M values a channel (JAX's ``_bn_bwd``, ``:231-236``), in x's
    dtype, computed in f32."""
    sg, sgx = sums[0], sums[1]
    xc = x.to(torch.float32) - mean[:, None]
    xhat = xc * invstd[:, None]
    dx = (scale * invstd)[:, None] * (g.to(torch.float32) - (sg / M)[:, None]
                                      - xhat * (sgx / M)[:, None])
    if gmean is not None:
        dx = dx + gmean[:, None] / M
    if gvar is not None:
        dx = dx + gvar[:, None] * 2.0 * xc / M
    return dx.to(x.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "bn_stats_launch": [_P] * 2 + [_I] * 5 + [_P, ctypes.POINTER(_I)],
    "bn_bwd_stats_launch": [_P] * 5 + [_I] * 4 + [_P],
    "bn_bwd_launch": [_P] * 9 + [_I] * 4 + [_P],
    "bn_bwd_dx_launch": [_P] * 9 + [_I] * 3 + [ctypes.c_float, _I, _P],
}
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from meg_decoding_tpu_torch.ops.kernels.build import load_library

        fn = getattr(load_library("batchnorm_stats"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
        _FNS[name] = fn
    return fn


def _stream(x: torch.Tensor) -> int:
    """The raw handle of the current stream on x's card."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _check(name: str, *xs: torch.Tensor) -> bool:
    """Validates (B, C, T) inputs of one dtype and device; True when they
    lie on the CPU (the plain version's case)."""
    x = xs[0]
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (B, C, T) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    dev = x.device
    for other in xs[1:]:
        if (other.shape, other.dtype, other.device) != (x.shape, x.dtype, dev):
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in xs:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    B, _, T = x.shape
    if B * T > _I32_MAX:
        raise ValueError(f"{name}: B·T = {B * T} exceeds the kernel's int32 index")
    return False


def _launch_stats(x: torch.Tensor, route: int
                  ) -> tuple[torch.Tensor, torch.Tensor, str]:
    """Launches bn_stats' kernel for the CUDA tensor x on ``route`` (an
    index of ``STATS_ROUTES``, or -1 for the launcher's pick): (Σx, Σx²,
    the route taken)."""
    B, C, T = x.shape
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    taken = ctypes.c_int(-1)
    err = _fn("bn_stats_launch")(x.data_ptr(), out.data_ptr(), B, C, T,
                                 int(x.dtype == torch.bfloat16), route,
                                 _stream(x), ctypes.byref(taken))
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: CUDA error {err}")
    name = STATS_ROUTES[taken.value]
    launches["bn_stats"] += 1
    stats_route_launches[name] += 1
    return out[0], out[1], name


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel of x (B, C, T) f32/bf16, each (C,) f32."""
    if _check("bn_stats", x):
        return bn_stats_plain(x)
    s, ss, _ = _launch_stats(x, -1)
    return s, ss


def _bn_stats_route(x: torch.Tensor, route: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, str]:
    """``bn_stats`` of the CUDA tensor x on ``route`` (one of
    ``STATS_ROUTES``) whatever the launcher would pick, or on its pick for
    None: (Σx, Σx², the route taken).  For ``chip_smoke.py``, which holds
    every route against the plain version and times them."""
    if _check("bn_stats", x):
        raise ValueError("_bn_stats_route launches the kernel: x must be a "
                         "CUDA tensor")
    return _launch_stats(x, -1 if route is None else STATS_ROUTES.index(route))


def _check_channels(name: str, x: torch.Tensor, *named) -> None:
    """Each (key, t) of ``named`` must be t None or (C,) f32 on x's
    device."""
    shape, dev, f32 = (x.shape[1],), x.device, torch.float32
    for key, t in named:
        if t is not None and (t.dtype is not f32 or t.shape != shape
                              or t.device != dev):
            raise ValueError(f"{name}: {key} must be ({shape[0]},) float32 on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")


def _contig(*ts: torch.Tensor | None) -> list:
    """Each tensor, a contiguous copy where it is not contiguous (kept by
    the caller until its launch is queued); None stays None."""
    return [t if t is None or t.is_contiguous() else t.contiguous() for t in ts]


def _ptrs(ts: list) -> list:
    return [None if t is None else t.data_ptr() for t in ts]


def bn_bwd_stats(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                 invstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) per channel, x̂ = (x − mean)·invstd; g, x (B, C, T) of
    one dtype (f32/bf16), mean and invstd (C,) f32 → each (C,) f32."""
    global sums_only_launches
    on_cpu = _check("bn_bwd_stats", x, g)
    _check_channels("bn_bwd_stats", x, ("mean", mean), ("invstd", invstd))
    if on_cpu:
        return bn_bwd_stats_plain(g, x, mean, invstd)
    B, C, T = x.shape
    vecs = _contig(mean, invstd)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _fn("bn_bwd_stats_launch")(
        g.data_ptr(), x.data_ptr(), *_ptrs(vecs), out.data_ptr(), B, C, T,
        int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_bwd_stats kernel launch failed: CUDA error {err}")
    launches["bn_bwd_stats"] += 1
    sums_only_launches += 1
    return out[0], out[1]


def bn_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
           mean: torch.Tensor, invstd: torch.Tensor,
           gmean: torch.Tensor | None = None, gvar: torch.Tensor | None = None
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The BatchNorm backward in one kernel: (dx, Σg, Σg·x̂) for g, x
    (B, C, T) of one dtype (f32/bf16); scale, mean and invstd (C,) f32;
    gmean and gvar, the cotangents of the batch mean and variance, (C,) f32
    or None.  dx is in x's dtype, the sums (C,) f32."""
    on_cpu = _check("bn_bwd", x, g)
    _check_channels("bn_bwd", x, ("scale", scale), ("mean", mean),
                    ("invstd", invstd), ("gmean", gmean), ("gvar", gvar))
    if on_cpu:
        return bn_bwd_plain(g, x, scale, mean, invstd, gmean, gvar)
    B, C, T = x.shape
    vecs = _contig(scale, mean, invstd, gmean, gvar)
    dx = torch.empty_like(x)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _fn("bn_bwd_launch")(
        g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dx.data_ptr(),
        out.data_ptr(), B, C, T, int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_bwd kernel launch failed: CUDA error {err}")
    launches["bn_bwd_stats"] += 1
    return dx, out[0], out[1]


def bn_bwd_dx(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
              mean: torch.Tensor, invstd: torch.Tensor, sums: torch.Tensor,
              M: int, gmean: torch.Tensor | None = None,
              gvar: torch.Tensor | None = None) -> torch.Tensor:
    """dx of the BatchNorm backward from given sums: g, x (B, C, T) of one
    dtype (f32/bf16); scale, mean and invstd (C,) f32; ``sums`` (2, C) f32
    = [Σg, Σg·x̂] over M values a channel (every rank's, all-reduced);
    gmean and gvar (C,) f32 or None.  dx in x's dtype."""
    global dx_launches
    on_cpu = _check("bn_bwd_dx", x, g)
    _check_channels("bn_bwd_dx", x, ("scale", scale), ("mean", mean),
                    ("invstd", invstd), ("gmean", gmean), ("gvar", gvar))
    B, C, T = x.shape
    if sums.shape != (2, C) or sums.dtype != torch.float32 \
            or sums.device != x.device:
        raise ValueError(f"bn_bwd_dx: sums must be (2, {C}) float32 on "
                         f"{x.device}, got {tuple(sums.shape)} {sums.dtype} "
                         f"{sums.device}")
    if not M > 0:
        raise ValueError(f"bn_bwd_dx: M must be positive, got {M}")
    if on_cpu:
        return bn_bwd_dx_plain(g, x, scale, mean, invstd, sums, M, gmean, gvar)
    vecs = _contig(scale, mean, invstd, gmean, gvar, sums)
    dx = torch.empty_like(x)
    err = _fn("bn_bwd_dx_launch")(
        g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dx.data_ptr(), B, C, T,
        float(M), int(x.dtype == torch.bfloat16), _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_bwd_dx kernel launch failed: CUDA error {err}")
    dx_launches += 1
    return dx
