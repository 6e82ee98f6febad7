"""The walks of the port's CUDA kernels, mirrored in numpy on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against
their plain versions there).  These tests repeat each kernel's own walk —
the same register layout, padding, stages and loads, with the constants
read from the CUDA source — and hold the result against the plain PyTorch
version and the JAX Pallas kernel (interpret mode) it replaces.

* ``csrc/robust_quantiles.cu``, register path: keys j·32 + lane in slot j
  of lane ``lane``, padded with INT32_MAX to 32·K slots, sorted by the
  warp-wide bitonic network in the order i = lane·K + j, order statistics
  read at lane r // K, slot r % K.  The sorted keys must equal a sort of
  the row; the percentiles must equal the plain version exactly and the
  Pallas kernel within 1 ulp with equal NaN positions (the blend is
  fma(v_lo, w_lo, v_hi·w_hi), here formed in f64 as the plain version
  does).
* ``csrc/batchnorm_stats.cu``, ``bn_stats``: one CTA per channel, thread
  t on the channel's loads t, t + kThreads, ….  Every (row, load) must be
  visited exactly once; the sums in the kernel's order (f32, fma emulated
  in f64) within rtol 1e-5 / atol 1e-4 of the plain version and the Pallas
  kernel (f32 sums taken in another order, as
  tests/test_torch_port_train_modules.py).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meg_decoding_tpu.ops.pallas import batchnorm as jbn
from meg_decoding_tpu.ops.pallas import quantile as jq
from meg_decoding_tpu_torch.cli.profile_train_step import kernel_group
from meg_decoding_tpu_torch.ops.kernels import batchnorm as tbnk
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import quantile as tq
from tests.test_torch_port_kernels import _hard_rows, _ulp_diff

I32_MAX = np.int32(np.iinfo(np.int32).max)


def _source(name: str) -> str:
    with open(os.path.join(build.CSRC_DIR, f"{name}.cu")) as f:
        return f.read()


def _const(name: str, source: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source(source))
    assert m, f"{name} not found in csrc/{source}.cu"
    return int(m.group(1))


# --- robust_quantiles: the register bitonic sort ---------------------------

def _keys_per_lane(T: int) -> int:
    """K: the power of two ≥ ceil(T / 32), as the launcher picks it."""
    K = 1
    while K < -(-T // 32):
        K *= 2
    return K


def _flip(b: np.ndarray) -> np.ndarray:
    return np.where(b < 0, b ^ I32_MAX, b)


def _load_registers(x: np.ndarray) -> np.ndarray:
    """(N, T) f32 → keys (N, 32, K): slot j of lane l holds key j·32 + l,
    INT32_MAX past the row's end."""
    N, T = x.shape
    K = _keys_per_lane(T)
    keys = _flip(x.view(np.int32))
    v = np.full((N, 32, K), I32_MAX, np.int32)
    for j in range(K):
        for lane in range(32):
            if j * 32 + lane < T:
                v[:, lane, j] = keys[:, j * 32 + lane]
    return v


def _cas(v: np.ndarray, j: int, p: int) -> None:
    a, b = v[:, :, j].copy(), v[:, :, p].copy()
    v[:, :, j], v[:, :, p] = np.minimum(a, b), np.maximum(a, b)


def _cross(v: np.ndarray, o: np.ndarray, lower: np.ndarray) -> np.ndarray:
    return np.where(lower[None, :, None], np.minimum(v, o), np.maximum(v, o))


def _warp_bitonic_sort(v: np.ndarray) -> np.ndarray:
    """The kernel's network on (N, 32, K) registers, stage by stage."""
    v = v.copy()
    K = v.shape[2]
    lanes = np.arange(32)
    for lk in range(1, K.bit_length() - 1 + 5 + 1):
        k = 1 << lk
        if k <= K:  # flip stage inside the lane
            for j in range(K):
                if (j ^ (k - 1)) > j:
                    _cas(v, j, j ^ (k - 1))
        else:  # flip stage across lanes: slot K-1-j of lane ^ (k/K - 1)
            o = v[:, lanes ^ (k // K - 1), ::-1]
            v = _cross(v, o, (lanes & (k // (2 * K))) == 0)
        for ld in range(lk - 2, -1, -1):  # half-cleaners
            d = 1 << ld
            if d < K:
                for j in range(K):
                    if j & d == 0:
                        _cas(v, j, j | d)
            else:
                m = d // K
                v = _cross(v, v[:, lanes ^ m, :], (lanes & m) == 0)
    return v


def _register_quantiles(x: np.ndarray, qs=(25.0, 50.0, 75.0)):
    """The register path end to end: (sorted keys (N, 32·K), (N, n) f32)."""
    v = _warp_bitonic_sort(_load_registers(x))
    K = v.shape[2]

    def value_at(r):
        return _flip(v[:, r // K, r % K]).view(np.float32)

    cols = []
    for rank, w_lo, w_hi, interp in tq.ranks_and_weights(x.shape[1], qs):
        v_lo = value_at(rank)
        if not interp:
            cols.append(v_lo)
            continue
        v_hi = value_at(rank + 1)
        with np.errstate(invalid="ignore", over="ignore"):
            cols.append((v_lo.astype(np.float64) * w_lo
                         + (v_hi * np.float32(w_hi)).astype(np.float64)
                         ).astype(np.float32))
    return v.reshape(len(x), -1), np.stack(cols, axis=1)


def _with_run_row(x: np.ndarray) -> np.ndarray:
    """Row 9: the six order statistics of the 25/50/75th percentiles all
    inside one run of equal values."""
    T = x.shape[1]
    if T >= 8:
        lo, hi = T // 5, T - T // 5
        x[9, :lo] = -1.0 - np.abs(x[9, :lo])
        x[9, lo:hi] = 0.5
        x[9, hi:] = 2.0 + np.abs(x[9, hi:])
    return x


@pytest.mark.parametrize("T", [1, 2, 7, 31, 32, 33, 360, 512, 1024])
def test_register_bitonic_sort_matches_plain_and_pallas(T):
    assert T <= tq.REGISTER_MAX_T
    x = _with_run_row(_hard_rows(T, np.random.RandomState(1000 + T)))
    sorted_keys, got = _register_quantiles(x)
    K = _keys_per_lane(T)
    assert K <= 32 and 32 * K >= T and (K == 1 or 32 * K < 2 * T + 32)
    # a sort of the row, the pads after every key
    np.testing.assert_array_equal(sorted_keys[:, :T],
                                  np.sort(_flip(x.view(np.int32)), axis=1))
    assert (sorted_keys[:, T:] == I32_MAX).all()
    plain = tq.robust_quantiles_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    want = np.asarray(jq.robust_quantiles(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert _ulp_diff(got, want) <= 1
    if T >= 8:
        np.testing.assert_array_equal(got[9], np.float32(0.5))


def test_register_path_limit_matches_the_source():
    src = "robust_quantiles"
    assert _const("kRegisterMaxT", src) == tq.REGISTER_MAX_T == 32 * 32
    assert tq.REGISTER_MAX_T < tq._MAX_T


# --- bn_stats: each thread's walk over its channel ---------------------------

def _threads() -> int:
    return _const("kThreads", "batchnorm_stats")


def _thread_walk(n: int, t: int, threads: int):
    """Thread t's loads of a channel's n, in its order."""
    return range(t, n, threads)


@pytest.mark.parametrize("B", [1, 3, 64, 65])
def test_bn_stats_walk_covers_every_row_once(B):
    threads = _threads()
    assert threads % 32 == 0
    # 16-byte loads of f32 / bf16 rows of 360, element-wise rows of 37 and
    # rows of one load
    for tv in (90, 45, 37, 1):
        seen = np.zeros((B, tv), np.int64)
        for t in range(threads):
            for i in _thread_walk(B * tv, t, threads):
                seen[divmod(i, tv)] += 1
        assert (seen == 1).all(), f"B={B} tv={tv}"


def _mirror_bn_stats(x: np.ndarray, V: int) -> np.ndarray:
    """Σx and Σx² per channel of (B, C, T) f32 in the kernel's order: each
    thread's walk, the warps' shuffle-down trees, then the warps in order."""
    threads = _threads()
    B, C, T = x.shape
    tv = T // V
    f32 = np.float32
    out = np.zeros((2, C), f32)
    for c in range(C):
        s = np.zeros(threads, f32)
        ss = np.zeros(threads, f32)
        for t in range(threads):
            a, q = f32(0), f32(0)
            for i in _thread_walk(B * tv, t, threads):
                b, j = divmod(i, tv)
                for e in x[b, c, j * V:(j + 1) * V]:
                    a = f32(a + e)
                    q = f32(np.float64(e) * np.float64(e) + np.float64(q))
            s[t], ss[t] = a, q
        for k, arr in enumerate((s.reshape(-1, 32), ss.reshape(-1, 32))):
            arr = arr.copy()
            for o in (16, 8, 4, 2, 1):
                arr[:, :o] = arr[:, :o] + arr[:, o:2 * o]
            total = arr[0, 0]
            for w in range(1, arr.shape[0]):
                total = f32(total + arr[w, 0])
            out[k, c] = total
    return out


@pytest.mark.parametrize("B", [1, 3, 64, 65])
def test_bn_stats_walk_sums_match_plain_and_pallas(B):
    C, T = 2, 40
    rng = np.random.RandomState(B)
    x = (rng.randn(B, C, T) * 3 + 1.5).astype(np.float32)
    plain = tbnk.bn_stats_plain(torch.from_numpy(x))
    x2d = np.ascontiguousarray(np.swapaxes(x, 1, 2).reshape(-1, C))
    pallas = jbn.bn_stats(jnp.asarray(x2d), block_rows=256, interpret=True)
    for V in (4, 1):  # the 16-byte loop and the element-wise loop
        got = _mirror_bn_stats(x, V)
        for k in range(2):
            np.testing.assert_allclose(got[k], plain[k].numpy(), rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_allclose(got[k], np.asarray(pallas[k]),
                                       rtol=1e-5, atol=1e-4)


# --- the profile's kernel groups --------------------------------------------

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")


@pytest.mark.parametrize("source,group", [
    ("window_gather", "window_gather"),
    ("robust_quantiles", "robust_quantiles"),
    ("batchnorm_stats", "bn_statistics"),
])
def test_profile_groups_every_kernel_of_its_source(source, group):
    """cli/profile_train_step.py sorts each __global__ of a source into the
    kernel's group, under the name the profiler reports."""
    names = _GLOBAL.findall(_source(source))
    assert names
    for name in names:
        assert kernel_group(f"void (anonymous namespace)::{name}<float>"
                            "(float const*, float*, int)") == group, name
