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

``bn_stats``, ``bn_bwd_stats`` and ``bn_bwd`` launch their kernel for a
CUDA tensor and run the plain version only for a CPU tensor.  The plain
versions are the ``'xla'`` branch math of the JAX package's ``_fwd_stats``
/ ``_bn_bwd``.  ``bn_bwd``'s launches count under ``"bn_bwd_stats"``: its
kernel is the one that replaces the Pallas ``bn_bwd_stats`` on the train
path.  ``sums_only_launches`` counts ``bn_bwd_stats``'s launches alone, so
that a caller can tell the two apart.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["bn_stats", "bn_stats_plain", "bn_bwd_stats", "bn_bwd_stats_plain",
           "bn_bwd", "bn_bwd_plain", "launches", "sums_only_launches",
           "reset_launches"]

_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2**31 - 1

# kernel launches since the last reset_launches(), per kernel
launches = {"bn_stats": 0, "bn_bwd_stats": 0}
# of launches["bn_bwd_stats"], those of bn_bwd_stats (the sums without dx)
sums_only_launches = 0


def reset_launches() -> None:
    global sums_only_launches
    for k in launches:
        launches[k] = 0
    sums_only_launches = 0


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
    M = x.numel() // x.shape[1]
    xc = x.to(torch.float32) - mean[:, None]
    xhat = xc * invstd[:, None]
    dx = (scale * invstd)[:, None] * (g.to(torch.float32) - (sg / M)[:, None]
                                      - xhat * (sgx / M)[:, None])
    if gmean is not None:
        dx = dx + gmean[:, None] / M
    if gvar is not None:
        dx = dx + gvar[:, None] * 2.0 * xc / M
    return dx.to(x.dtype), sg, sgx


_N_PTR = {"bn_stats_launch": 2, "bn_bwd_stats_launch": 5, "bn_bwd_launch": 9}


def _fn(name: str):
    from meg_decoding_tpu_torch.ops.kernels.build import load_library

    fn = getattr(load_library("batchnorm_stats"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * _N_PTR[name] + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return fn


def _check(name: str, *xs: torch.Tensor) -> bool:
    """Validates (B, C, T) inputs of one dtype and device; True when they
    lie on the CPU (the plain version's case)."""
    x = xs[0]
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (B, C, T) tensor, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    for other in xs[1:]:
        if (other.shape, other.dtype, other.device) != (x.shape, x.dtype, x.device):
            raise ValueError(f"{name}: inputs differ in shape, dtype or device")
    if x.device.type == "cpu":
        return True
    if not x.is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError(f"{name}: inputs must be contiguous")
    B, _, T = x.shape
    if B * T > _I32_MAX:
        raise ValueError(f"{name}: B·T = {B * T} exceeds the kernel's int32 index")
    return False


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σx, Σx²) per channel of x (B, C, T) f32/bf16, each (C,) f32."""
    if _check("bn_stats", x):
        return bn_stats_plain(x)
    B, C, T = x.shape
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _fn("bn_stats_launch")(
        x.data_ptr(), out.data_ptr(), B, C, T, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: CUDA error {err}")
    launches["bn_stats"] += 1
    return out[0], out[1]


def _check_channels(name: str, x: torch.Tensor, **vectors) -> None:
    """Each of ``vectors`` (None allowed) must be (C,) f32 on x's device."""
    C = x.shape[1]
    for key, t in vectors.items():
        if t is None:
            continue
        if t.shape != (C,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name}: {key} must be ({C},) float32 on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def bn_bwd_stats(g: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                 invstd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σg, Σg·x̂) per channel, x̂ = (x − mean)·invstd; g, x (B, C, T) of
    one dtype (f32/bf16), mean and invstd (C,) f32 → each (C,) f32."""
    global sums_only_launches
    on_cpu = _check("bn_bwd_stats", x, g)
    _check_channels("bn_bwd_stats", x, mean=mean, invstd=invstd)
    if on_cpu:
        return bn_bwd_stats_plain(g, x, mean, invstd)
    B, C, T = x.shape
    mean, invstd = mean.contiguous(), invstd.contiguous()
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _fn("bn_bwd_stats_launch")(
        g.data_ptr(), x.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        out.data_ptr(), B, C, T, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
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
    _check_channels("bn_bwd", x, scale=scale, mean=mean, invstd=invstd,
                    gmean=gmean, gvar=gvar)
    if on_cpu:
        return bn_bwd_plain(g, x, scale, mean, invstd, gmean, gvar)
    B, C, T = x.shape
    vecs = [None if t is None else t.contiguous()
            for t in (scale, mean, invstd, gmean, gvar)]
    dx = torch.empty_like(x)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    err = _fn("bn_bwd_launch")(
        g.data_ptr(), x.data_ptr(), *map(_ptr, vecs), dx.data_ptr(),
        out.data_ptr(), B, C, T, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_bwd kernel launch failed: CUDA error {err}")
    launches["bn_bwd_stats"] += 1
    return dx, out[0], out[1]
