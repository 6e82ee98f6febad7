"""Build the port's CUDA kernels from ``csrc/`` and load them with ctypes.

The sources are ``window_gather.cu``, ``robust_quantiles.cu`` and
``batchnorm_stats.cu`` (``bn_stats``, ``bn_bwd_stats`` and ``bn_bwd``).  Each
``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``meg_decoding_tpu_torch/_build/`` (ignored by git).  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Building happens at first use
(``load_library``) or up front for several kernels at once, one ``nvcc``
process per source, all started together (``build``).

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["KERNELS", "NVCC_FLAGS", "BUILD_DIR", "CSRC_DIR", "find_nvcc",
           "build", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNELS = ("window_gather", "robust_quantiles", "batchnorm_stats")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA "
        "toolkit")


def _lib_path(name: str) -> tuple[str, str]:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r} (known: {KERNELS})")
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict:
    """Compile every kernel of ``names`` not built yet, one ``nvcc`` per
    source, all in parallel.  Returns ``{"seconds": wall time, "log":
    {name: nvcc output (ptxas register and shared-memory report)}}``;
    raises with the compiler's output when one fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib = _lib_path(name)
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    log, failed = {}, {}
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        log[name] = out
        if proc.returncode != 0:
            failed[name] = out
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n} ---\n{o}" for n, o in failed.items()))
    return {"seconds": time.perf_counter() - t0, "log": log}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(_lib_path(name)[1])
            _LIBS[name] = lib
        return lib
