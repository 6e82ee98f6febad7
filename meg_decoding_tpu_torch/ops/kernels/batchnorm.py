"""Training-mode BatchNorm kernels: the CUDA kernels
``csrc/batchnorm_stats.cu`` and their plain PyTorch versions.

Port of ``bn_stats`` and ``bn_bwd_stats`` from
``meg_decoding_tpu/ops/pallas/batchnorm.py``.  Training-mode BatchNorm
needs, per channel, (Σx, Σx²) in the forward and (Σg, Σg·x̂) in the
backward, with x̂ = (x − mean)·invstd, each in one read of its inputs and
accumulated in f32.  ``bn_bwd`` is the whole backward in one kernel: the
backward sums and, from them, the input gradient dx that the JAX custom
VJP computes after its Pallas kernel (``_bn_bwd``), reading g and x once.

Two layouts: NCW ``(B, C, T)``, the channel dim 1 and the sums over dims 0
and 2 (the f32 encoder's activations), and, with ``time_major=True``,
``(B, T, C)``, M = B·T rows of C contiguous channels and the sums over dims
0 and 1 (the bf16 encoder's, ``models/layers.py``; the JAX kernels' ``(M,
C)``).  Inputs are f32 or bf16; the sums are f32.

``bn_bwd_dx`` is that dx from sums and a count the caller gives: synced
BatchNorm under data parallelism all-reduces ``bn_bwd_stats``'s sums over
the ranks and takes dx from the global sums with M the global B·T
(``ops/batchnorm.py``), where the fused ``bn_bwd`` cannot serve (its dx
needs sums that are not yet global).

On NCW, ``bn_stats`` takes one of two routes of its kernel, picked by the
launcher from the channel count and a channel's size: a thread-block
cluster per channel (``cluster``: few long channels, as EEGNet's bn1
(64, 16, 528)) or one CTA per channel (``per_channel``: the f32 speech
step's (64, 320, 360), GOD's (64, 320, 24) and every other shape); and
``bn_bwd`` one of two kernels, the channel in registers (``registers``:
f32 channels that fit) or walked twice (``two_walk``).  Time-major inputs
take the ``time_major`` route of each: one cooperative kernel a call, each
CTA a chunk of whole rows, the chunks' sums added in a fixed order after a
grid barrier.
``stats_route_launches`` and ``bwd_route_launches`` count the launches of
each route, as the launchers report them.

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
           "STATS_ROUTES", "BWD_ROUTES", "launches", "stats_route_launches",
           "bwd_route_launches", "sums_only_launches", "dx_launches",
           "reset_launches"]

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2**31 - 1

# bn_stats' routes: the NCW kernel's, in the order of its route argument,
# then the time-major kernel
STATS_ROUTES = ("per_channel", "cluster", "time_major")
# bn_bwd's (and bn_bwd_stats'): the NCW kernels', in the order the launcher
# reports them, then the time-major kernel
BWD_ROUTES = ("registers", "two_walk", "time_major")

# kernel launches since the last reset_launches(), per kernel (a replay of a
# captured train step adds what its capture counted, train/graph.py)
launches = {"bn_stats": 0, "bn_bwd_stats": 0}
# of launches["bn_stats"], those of each route
stats_route_launches = dict.fromkeys(STATS_ROUTES, 0)
# of launches["bn_bwd_stats"], those of each route
bwd_route_launches = dict.fromkeys(BWD_ROUTES, 0)
# of launches["bn_bwd_stats"], those of bn_bwd_stats (the sums without dx)
sums_only_launches = 0
# launches of bn_bwd_dx (dx from given sums: synced BatchNorm)
dx_launches = 0


def reset_launches() -> None:
    global sums_only_launches, dx_launches
    for counts in (launches, stats_route_launches, bwd_route_launches):
        for k in counts:
            counts[k] = 0
    sums_only_launches = 0
    dx_launches = 0


def _channel_dim(time_major: bool) -> int:
    return 2 if time_major else 1


def _over(time_major: bool) -> tuple[int, int]:
    """The dims a channel's sums run over."""
    return (0, 1) if time_major else (0, 2)


def _per_channel(v: torch.Tensor, time_major: bool) -> torch.Tensor:
    """(C,) v broadcast along the channel dim of the layout."""
    return v if time_major else v[:, None]


def bn_stats_plain(x: torch.Tensor, time_major: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, T), or time-major (B, T, C) → (Σx, Σx²) per channel, each
    (C,) f32."""
    xf = x.to(torch.float32)
    dims = _over(time_major)
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def bn_bwd_stats_plain(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                       invstd: torch.Tensor, time_major: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) per channel of (B, C, T) inputs, or time-major (B, T, C),
    each (C,) f32."""
    gf = g.to(torch.float32)
    xhat = ((x.to(torch.float32) - _per_channel(mean, time_major))
            * _per_channel(invstd, time_major))
    dims = _over(time_major)
    return gf.sum(dim=dims), (gf * xhat).sum(dim=dims)


def bn_bwd_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                 mean: torch.Tensor, invstd: torch.Tensor,
                 gmean: torch.Tensor | None = None,
                 gvar: torch.Tensor | None = None, time_major: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, Σg, Σg·x̂): the BatchNorm backward of (B, C, T) inputs, or
    time-major (B, T, C), dx in x's dtype computed in f32, the sums (C,)
    f32.  gmean and gvar are the cotangents of the batch mean and variance,
    or None."""
    sg, sgx = bn_bwd_stats_plain(g, x, mean, invstd, time_major)
    dx = bn_bwd_dx_plain(g, x, scale, mean, invstd, torch.stack([sg, sgx]),
                         x.numel() // x.shape[_channel_dim(time_major)], gmean,
                         gvar, time_major)
    return dx, sg, sgx


def bn_bwd_dx_plain(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    mean: torch.Tensor, invstd: torch.Tensor,
                    sums: torch.Tensor, M: int,
                    gmean: torch.Tensor | None = None,
                    gvar: torch.Tensor | None = None,
                    time_major: bool = False) -> torch.Tensor:
    """dx of the BatchNorm backward from given sums (2, C) = [Σg, Σg·x̂]
    over M values a channel (JAX's ``_bn_bwd``, ``:231-236``), in x's
    dtype, computed in f32; (B, C, T) inputs, or time-major (B, T, C)."""
    ch = lambda v: _per_channel(v, time_major)
    sg, sgx = sums[0], sums[1]
    xc = x.to(torch.float32) - ch(mean)
    xhat = xc * ch(invstd)
    dx = ch(scale * invstd) * (g.to(torch.float32) - ch(sg / M)
                               - xhat * ch(sgx / M))
    if gmean is not None:
        dx = dx + ch(gmean) / M
    if gvar is not None:
        dx = dx + ch(gvar) * 2.0 * xc / M
    return dx.to(x.dtype)


_P, _I, _IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
_I64 = ctypes.c_longlong
_ARGTYPES = {
    "bn_stats_launch": [_P] * 2 + [_I] * 5 + [_P, _IP],
    "bn_bwd_launch": [_P] * 9 + [_I] * 4 + [_P, _IP],
    "bn_bwd_dx_launch": [_P] * 9 + [_I] * 3 + [ctypes.c_float, _I, _P],
    "bn_stats_tm_launch": [_P] * 3 + [_I64] + [_I] * 3 + [_P, _IP],
    "bn_bwd_tm_launch": [_P] * 10 + [_I64] + [_I] * 3 + [_P, _IP],
    "bn_bwd_dx_tm_launch": [_P] * 9 + [_I] * 2 + [ctypes.c_float, _I, _P],
}
_FNS: dict = {}
_SMS: dict = {}  # SMs by device


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


def _check(name: str, *xs: torch.Tensor, time_major: bool = False) -> bool:
    """Validates (B, C, T) inputs, or time-major (B, T, C), of one dtype and
    device; True when they lie on the CPU (the plain version's case)."""
    x = xs[0]
    if x.dim() != 3 or x.numel() == 0:
        layout = "(B, T, C)" if time_major else "(B, C, T)"
        raise ValueError(f"{name} takes a non-empty {layout} tensor, got "
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
    rows = x.numel() // x.shape[_channel_dim(time_major)]
    if rows > _I32_MAX:
        raise ValueError(f"{name}: B·T = {rows} exceeds the kernel's int32 index")
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


def _workspace(x: torch.Tensor, C: int) -> torch.Tensor:
    """The time-major kernels' scratch for the chunks' partial sums: 4·SMs
    rows of (2, C) f32, more than the chunks the launcher picks (two CTAs
    an SM) and its segment sums need."""
    sms = _SMS.get(x.device)
    if sms is None:
        sms = _SMS[x.device] = torch.cuda.get_device_properties(
            x.device).multi_processor_count
    return torch.empty(4 * sms * 2 * C, dtype=torch.float32, device=x.device)


def _launch_stats_tm(x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, tuple[int, int]]:
    """Launches bn_stats' time-major kernel for the CUDA tensor x (B, T, C):
    (Σx, Σx², the plan taken: (chunks of rows, tiles of channels))."""
    C = x.shape[2]
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    ws = _workspace(x, C)
    plan = (ctypes.c_int * 2)(0, 0)
    err = _fn("bn_stats_tm_launch")(x.data_ptr(), out.data_ptr(),
                                    ws.data_ptr(), ws.numel(), x.numel() // C,
                                    C, int(x.dtype == torch.bfloat16),
                                    _stream(x), plan)
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: CUDA error {err}")
    launches["bn_stats"] += 1
    stats_route_launches["time_major"] += 1
    return out[0], out[1], (plan[0], plan[1])


def bn_stats(x: torch.Tensor, time_major: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel of x (B, C, T), or time-major (B, T, C),
    f32/bf16, each (C,) f32."""
    if _check("bn_stats", x, time_major=time_major):
        return bn_stats_plain(x, time_major)
    if time_major:
        s, ss, _ = _launch_stats_tm(x)
    else:
        s, ss, _ = _launch_stats(x, -1)
    return s, ss


def _bn_stats_route(x: torch.Tensor, route: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, str]:
    """``bn_stats`` of the CUDA tensor x (B, C, T) on ``route`` (one of the
    NCW kernel's ``STATS_ROUTES``) whatever the launcher would pick, or on
    its pick for None: (Σx, Σx², the route taken).  For ``chip_smoke.py``,
    which holds every route against the plain version and times them."""
    if _check("bn_stats", x):
        raise ValueError("_bn_stats_route launches the kernel: x must be a "
                         "CUDA tensor")
    if route == "time_major":
        raise ValueError("the time_major route takes (B, T, C): "
                         "bn_stats(x, time_major=True)")
    return _launch_stats(x, -1 if route is None else STATS_ROUTES.index(route))


def _check_channels(name: str, x: torch.Tensor, *named,
                    time_major: bool = False) -> None:
    """Each (key, t) of ``named`` must be t None or (C,) f32 on x's
    device."""
    shape, dev, f32 = ((x.shape[_channel_dim(time_major)],), x.device,
                       torch.float32)
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


def _launch_bwd(g: torch.Tensor, x: torch.Tensor, vecs: list,
                dx: torch.Tensor | None, time_major: bool
                ) -> tuple[torch.Tensor, tuple[int, int] | None]:
    """Launches bn_bwd's kernel on its layout's route, dx None for the sums
    alone; vecs are scale, mean, invstd, gmean, gvar (scale, gmean, gvar
    None for the sums alone).  Counts the launch and its route; returns the
    (2, C) sums and, time-major, the plan taken (as ``_launch_stats_tm``)."""
    C = x.shape[_channel_dim(time_major)]
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    dxp = None if dx is None else dx.data_ptr()
    plan = None
    if time_major:
        ws = _workspace(x, C)
        plan = (ctypes.c_int * 2)(0, 0)
        err = _fn("bn_bwd_tm_launch")(
            g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dxp, out.data_ptr(),
            ws.data_ptr(), ws.numel(), x.numel() // C, C, bf16, _stream(x),
            plan)
    else:
        B, _, T = x.shape
        taken = ctypes.c_int(-1)
        err = _fn("bn_bwd_launch")(
            g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dxp, out.data_ptr(), B,
            C, T, bf16, _stream(x), ctypes.byref(taken))
    if err != 0:
        what = "bn_bwd" if dx is not None else "bn_bwd_stats"
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    launches["bn_bwd_stats"] += 1
    if time_major:
        bwd_route_launches["time_major"] += 1
        return out, (plan[0], plan[1])
    bwd_route_launches[BWD_ROUTES[taken.value]] += 1
    return out, None


def bn_bwd_stats(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                 invstd: torch.Tensor, time_major: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) per channel, x̂ = (x − mean)·invstd; g, x (B, C, T), or
    time-major (B, T, C), of one dtype (f32/bf16), mean and invstd (C,) f32
    → each (C,) f32."""
    global sums_only_launches
    on_cpu = _check("bn_bwd_stats", x, g, time_major=time_major)
    _check_channels("bn_bwd_stats", x, ("mean", mean), ("invstd", invstd),
                    time_major=time_major)
    if on_cpu:
        return bn_bwd_stats_plain(g, x, mean, invstd, time_major)
    vecs = _contig(None, mean, invstd, None, None)
    out, _ = _launch_bwd(g, x, vecs, None, time_major)
    sums_only_launches += 1
    return out[0], out[1]


def bn_bwd(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
           mean: torch.Tensor, invstd: torch.Tensor,
           gmean: torch.Tensor | None = None, gvar: torch.Tensor | None = None,
           time_major: bool = False
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The BatchNorm backward in one kernel: (dx, Σg, Σg·x̂) for g, x
    (B, C, T), or time-major (B, T, C), of one dtype (f32/bf16); scale,
    mean and invstd (C,) f32; gmean and gvar, the cotangents of the batch
    mean and variance, (C,) f32 or None.  dx is in x's dtype, the sums (C,)
    f32."""
    on_cpu = _check("bn_bwd", x, g, time_major=time_major)
    _check_channels("bn_bwd", x, ("scale", scale), ("mean", mean),
                    ("invstd", invstd), ("gmean", gmean), ("gvar", gvar),
                    time_major=time_major)
    if on_cpu:
        return bn_bwd_plain(g, x, scale, mean, invstd, gmean, gvar, time_major)
    vecs = _contig(scale, mean, invstd, gmean, gvar)
    dx = torch.empty_like(x)
    out, _ = _launch_bwd(g, x, vecs, dx, time_major)
    return dx, out[0], out[1]


def bn_bwd_dx(g: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
              mean: torch.Tensor, invstd: torch.Tensor, sums: torch.Tensor,
              M: int, gmean: torch.Tensor | None = None,
              gvar: torch.Tensor | None = None, time_major: bool = False
              ) -> torch.Tensor:
    """dx of the BatchNorm backward from given sums: g, x (B, C, T), or
    time-major (B, T, C), of one dtype (f32/bf16); scale, mean and invstd
    (C,) f32; ``sums`` (2, C) f32 = [Σg, Σg·x̂] over M values a channel
    (every rank's, all-reduced); gmean and gvar (C,) f32 or None.  dx in
    x's dtype."""
    global dx_launches
    on_cpu = _check("bn_bwd_dx", x, g, time_major=time_major)
    _check_channels("bn_bwd_dx", x, ("scale", scale), ("mean", mean),
                    ("invstd", invstd), ("gmean", gmean), ("gvar", gvar),
                    time_major=time_major)
    C = x.shape[_channel_dim(time_major)]
    if sums.shape != (2, C) or sums.dtype != torch.float32 \
            or sums.device != x.device:
        raise ValueError(f"bn_bwd_dx: sums must be (2, {C}) float32 on "
                         f"{x.device}, got {tuple(sums.shape)} {sums.dtype} "
                         f"{sums.device}")
    if not M > 0:
        raise ValueError(f"bn_bwd_dx: M must be positive, got {M}")
    if on_cpu:
        return bn_bwd_dx_plain(g, x, scale, mean, invstd, sums, M, gmean, gvar,
                               time_major)
    vecs = _contig(scale, mean, invstd, gmean, gvar, sums)
    dx = torch.empty_like(x)
    bf16 = int(x.dtype == torch.bfloat16)
    if time_major:
        err = _fn("bn_bwd_dx_tm_launch")(
            g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dx.data_ptr(),
            x.numel() // C, C, float(M), bf16, _stream(x))
    else:
        B, _, T = x.shape
        err = _fn("bn_bwd_dx_launch")(
            g.data_ptr(), x.data_ptr(), *_ptrs(vecs), dx.data_ptr(), B, C, T,
            float(M), bf16, _stream(x))
    if err != 0:
        raise RuntimeError(f"bn_bwd_dx kernel launch failed: CUDA error {err}")
    dx_launches += 1
    return dx
