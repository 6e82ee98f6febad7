"""Batched (recording, onset) → window gather: the CUDA kernel
``csrc/window_gather.cu`` and its plain PyTorch version.

Port of ``meg_decoding_tpu/ops/pallas/window_gather.py``.  The Gwilliams
batch needs ``X[b] = recordings[rec_id_b, :, onset_b : onset_b + L]`` — a
data-dependent window per sample out of device-resident continuous
recordings — twice per batch (the X and the Y window).

Onsets are clamped to ``[0, T − padded_window(L)]``, the bound of the TPU
kernel's aligned overfetch; callers pad the time axis with
``pad_time_for_gather`` exactly as the JAX package does, so an
out-of-range onset selects the same window on both sides.

``window_gather`` launches the kernel for a CUDA tensor and runs the plain
version (advanced indexing) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["window_gather", "window_gather_plain", "padded_window",
           "pad_time_for_gather", "launches", "reset_launches"]

_LANE = 128

# kernel launches since the last reset_launches() (read by chip_smoke.py to
# show that a run went through the kernel)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def padded_window(length: int) -> int:
    """The TPU kernel's aligned fetch size for a length-``length`` window:
    the smallest multiple of 128 ≥ length + 127.  Only its clamp bound
    matters here."""
    return ((length + 2 * _LANE - 2) // _LANE) * _LANE


def pad_time_for_gather(T: int, length: int) -> int:
    """Time-axis size the source must be padded to."""
    W = padded_window(length)
    return ((T + W + _LANE - 1) // _LANE) * _LANE


def _max_onset(T: int, length: int) -> int:
    W = padded_window(length)
    if T < W:
        raise ValueError(
            f"src time axis {T} is too short for the gather's clamp bound "
            f"({W}); pad it with pad_time_for_gather(T, length) first")
    return T - W


def window_gather_plain(src: torch.Tensor, rec_ids: torch.Tensor,
                        onsets: torch.Tensor, length: int,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Advanced-indexing version: src (R, C, T), rec_ids (B,), onsets (B,)
    → (B, C, length)."""
    R, C, T = src.shape
    on = onsets.long().clamp(0, _max_onset(T, length))
    rec = rec_ids.long().clamp(0, R - 1)
    t_idx = on[:, None] + torch.arange(length, device=src.device)  # (B, L)
    c_idx = torch.arange(C, device=src.device)
    out = src[rec[:, None, None], c_idx[None, :, None], t_idx[:, None, :]]
    return out if out_dtype is None else out.to(out_dtype)


def _lib():
    from meg_decoding_tpu_torch.ops.kernels.build import load_library

    lib = load_library("window_gather")
    fn = lib.window_gather_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
    return fn


def window_gather(src: torch.Tensor, rec_ids: torch.Tensor,
                  onsets: torch.Tensor, length: int,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """src (R, C, T) f32, rec_ids (B,), onsets (B,) int → (B, C, length) in
    ``out_dtype`` (f32 or bf16; default f32).

    ``T`` must be ≥ ``padded_window(length)``; onsets are clamped to
    ``[0, T − padded_window(length)]`` and rec_ids to ``[0, R)``.  The bf16
    cast happens in registers and equals ``gather(...).to(bf16)``."""
    if src.dim() != 3 or rec_ids.dim() != 1 or onsets.shape != rec_ids.shape:
        raise ValueError(
            f"expected src (R, C, T), rec_ids (B,), onsets (B,); got "
            f"{tuple(src.shape)}, {tuple(rec_ids.shape)}, {tuple(onsets.shape)}")
    if src.dtype != torch.float32:
        raise TypeError(f"src must be float32, got {src.dtype}")
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if rec_ids.device != src.device or onsets.device != src.device:
        raise ValueError("src, rec_ids and onsets must be on one device")
    if src.device.type == "cpu":
        return window_gather_plain(src, rec_ids, onsets, length, out_dtype)
    if not src.is_cuda:
        raise ValueError(f"window_gather runs on cuda or cpu, not {src.device}")

    R, C, T = src.shape
    B = rec_ids.shape[0]
    max_onset = _max_onset(T, length)
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid (≤ 65535)")
    rec_ids = rec_ids.to(torch.int32).contiguous()
    onsets = onsets.to(torch.int32).contiguous()
    out_dtype = out_dtype or torch.float32
    out = torch.empty((B, C, length), dtype=out_dtype, device=src.device)
    err = _lib()(src.data_ptr(), rec_ids.data_ptr(), onsets.data_ptr(),
                 out.data_ptr(), R, C, T, B, length, max_onset,
                 int(out_dtype == torch.bfloat16),
                 torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window_gather kernel launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out
