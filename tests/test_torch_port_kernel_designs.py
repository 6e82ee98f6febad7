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
* ``csrc/batchnorm_stats.cu``, ``bn_bwd``: the launcher's choice of kernel
  by shape; the register kernel's slots and persistent channel walk, and
  the two-walk kernel's division-free forward and reverse walks, each
  covering every vector once; the sums in the kernels' order against the
  plain version and the Pallas kernel (rtol 1e-5, atol 1e-4, as above);
  dx from those sums, each step rounded as the kernel rounds it, against
  ``bn_bwd_plain`` (f32 rtol 1e-5 / atol 1e-6: the sums' difference
  carried through; bf16 rtol/atol 2e-2, one rounding apart).
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


@pytest.mark.parametrize("T", [1, 2, 7, 24, 31, 32, 33, 360, 512, 1024])
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
    assert tq.REGISTER_MAX_T < tq.SHARED_MAX_T == _const("kSharedMaxT", src)


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
        out[0, c], out[1, c] = _cta_sum(s), _cta_sum(ss)
    return out


def _cta_sum(per_thread: np.ndarray) -> np.float32:
    """block_sum2: each warp's shuffle-down tree, then the warps' sums added
    in warp order by one thread."""
    arr = per_thread.reshape(-1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        arr[:, :o] = arr[:, :o] + arr[:, o:2 * o]
    total = arr[0, 0]
    for w in range(1, arr.shape[0]):
        total = np.float32(total + arr[w, 0])
    return total


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


# --- bn_bwd: the register kernel and the two-walk kernel -------------------

def _bwd_threads() -> int:
    return _const("kBwdThreads", "batchnorm_stats")


def _max_slots() -> int:
    return _const("kBwdMaxSlots", "batchnorm_stats")


def _bwd_pick(B: int, T: int, dtype: str, aligned: bool = True,
              with_dx: bool = True) -> tuple[str, int]:
    """launch_bwd's choice: ("registers", slots a thread) or ("two_walk", 0)."""
    V = 4 if dtype == "float32" else 8
    need = -(-(B * (T // V)) // _bwd_threads())
    if (dtype == "float32" and with_dx and aligned and T % V == 0
            and need <= _max_slots()):
        return "registers", _max_slots()
    return "two_walk", 0


def test_bn_bwd_slot_choices_match_the_source():
    """One register kernel of kBwdMaxSlots slots, taken when a thread's
    share of the channel fits them; it holds the training step's f32
    channel of 64 rows of 360."""
    src = _source("batchnorm_stats")
    assert "need <= kBwdMaxSlots" in src
    assert "constexpr int NV = kBwdMaxSlots;" in src
    assert len(re.findall(r"bn_bwd_reg_kernel<<<", src)) == 1
    assert _max_slots() * _bwd_threads() * 4 >= 64 * 360


@pytest.mark.parametrize("B,T,dtype,aligned,with_dx,want", [
    (64, 360, "float32", True, True, ("registers", 12)),  # the train path
    (65, 360, "float32", True, True, ("registers", 12)),
    (1, 40, "float32", True, True, ("registers", 12)),    # slots left unused
    (69, 360, "float32", True, True, ("two_walk", 0)),    # > 12 slots
    (256, 360, "float32", True, True, ("two_walk", 0)),
    (64, 360, "bfloat16", True, True, ("two_walk", 0)),   # the train path
    (3, 37, "float32", True, True, ("two_walk", 0)),      # rows unaligned
    (2, 64, "float32", False, True, ("two_walk", 0)),     # base unaligned
    (64, 360, "float32", True, False, ("two_walk", 0)),   # the sums alone
    (64, 24, "float32", True, True, ("registers", 12)),   # GOD: one slot used
    (64, 24, "bfloat16", True, True, ("two_walk", 0)),    # GOD
])
def test_bn_bwd_launcher_picks_the_kernel_by_shape(B, T, dtype, aligned,
                                                   with_dx, want):
    assert _bwd_pick(B, T, dtype, aligned, with_dx) == want


def test_bn_bwd_on_chip_budgets_at_the_training_shape():
    """(64, 320, 360): the f32 register kernel's slots fit the SM's 64 K
    registers and a thread's 255, its shared memory (block_sum2's warp sums
    and the totals) is far under 232,448 B; the bf16 two-walk kernel's g and
    x fit the 50 MB L2, so its second walk re-reads them from there."""
    threads = _bwd_threads()
    _, nv = _bwd_pick(64, 360, "float32")
    assert 2 * nv * 4 * threads <= 65536 and 2 * nv * 4 < 255
    assert (2 * (threads // 32) + 2) * 4 < 232448
    assert 2 * 64 * 320 * 360 * 2 <= 50 * 2**20


@pytest.mark.parametrize("B", [1, 3, 64, 65])
def test_bn_bwd_register_walk_loads_and_writes_every_vector_once(B):
    threads = _bwd_threads()
    n = B * 90  # f32 rows of 360: 90 vectors of 16 bytes
    kernel, nv = _bwd_pick(B, 360, "float32")
    assert kernel == "registers" and nv * threads >= n
    loaded = np.zeros(n, np.int64)
    for t in range(threads):
        for m in range(nv):
            if t + m * threads < n:
                loaded[t + m * threads] += 1
    # each loaded slot is written back as dx once, from the same registers
    assert (loaded == 1).all()
    # the persistent grid: CTA q takes channels q, q + grid, …
    for C in (1, 24, 320):
        grid = min(C, 132)
        seen = np.zeros(C, np.int64)
        for q in range(grid):
            seen[q::grid] += 1
        assert (seen == 1).all()


def _step(row, col, drow, dcol, tv, back=False):
    if back:
        row, col = row - drow, col - dcol
        return (row - 1, col + tv) if col < 0 else (row, col)
    row, col = row + drow, col + dcol
    return (row + 1, col - tv) if col >= tv else (row, col)


@pytest.mark.parametrize("B", [1, 3, 64, 65])
def test_bn_bwd_two_walk_visits_every_vector_once_each_way(B):
    """Thread t's (row, col), stepped without a division, are divmod(i, tv)
    for its vectors i = t, t + kBwdThreads, …; the dx walk visits the same
    vectors in reverse from one stride past the last."""
    threads = _bwd_threads()
    for tv in (90, 45, 37, 1):  # f32 / bf16 rows of 360, rows of 37, 1
        n = B * tv
        drow, dcol = divmod(threads, tv)
        seen = np.zeros(n, np.int64)
        for t in range(threads):
            row, col = divmod(t, tv)
            fwd = []
            for i in range(t, n, threads):
                assert (row, col) == divmod(i, tv)
                fwd.append((row, col))
                seen[i] += 1
                row, col = _step(row, col, drow, dcol, tv)
            back = []
            for _ in fwd:
                row, col = _step(row, col, drow, dcol, tv, back=True)
                back.append((row, col))
            assert back == fwd[::-1]
        assert (seen == 1).all(), f"B={B} tv={tv}"


def _mirror_bn_bwd_sums(g: np.ndarray, x: np.ndarray, mean: np.ndarray,
                        invstd: np.ndarray, V: int) -> np.ndarray:
    """Σg and Σg·x̂ per channel in both kernels' order: thread t's vectors
    t, t + kBwdThreads, … in turn (its registers' slots in the register
    kernel, its first walk in the two-walk kernel), then block_sum2."""
    threads = _bwd_threads()
    B, C, T = x.shape
    tv = T // V
    f32, f64 = np.float32, np.float64
    out = np.zeros((2, C), f32)
    for c in range(C):
        mu, inv = f32(mean[c]), f32(invstd[c])
        sg = np.zeros(threads, f32)
        sgx = np.zeros(threads, f32)
        for t in range(threads):
            a, q = f32(0), f32(0)
            for i in range(t, B * tv, threads):
                b, j = divmod(i, tv)
                for gv, xv in zip(g[b, c, j * V:(j + 1) * V],
                                  x[b, c, j * V:(j + 1) * V]):
                    a = f32(a + gv)
                    xh = f32(f32(xv - mu) * inv)
                    q = f32(f64(gv) * f64(xh) + f64(q))
            sg[t], sgx[t] = a, q
        out[0, c], out[1, c] = _cta_sum(sg), _cta_sum(sgx)
    return out


def _mirror_dx(g, x, scale, mean, invstd, sg, sgx) -> np.ndarray:
    """dx_of: each step rounded to f32 on its own, in the plain order."""
    f32 = np.float32
    M = f32(x.shape[0] * x.shape[2])
    col = lambda v: np.asarray(v, f32)[None, :, None]
    a = col(f32(scale) * f32(invstd))
    k1, k2 = col(f32(sg) / M), col(f32(sgx) / M)
    xc = x.astype(f32) - col(mean)
    xhat = xc * col(invstd)
    return a * ((g.astype(f32) - k1) - xhat * k2)


@pytest.mark.parametrize("B", [1, 3, 64, 65])
@pytest.mark.parametrize("dtype,V", [("float32", 4), ("bfloat16", 8)])
def test_bn_bwd_sums_and_dx_in_kernel_order_match_plain_and_pallas(dtype, V,
                                                                   B):
    C, T = 2, 40
    rng = np.random.RandomState(100 + B)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy((rng.randn(B, C, T) * 3 + 1.5).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.randn(B, C, T).astype(np.float32)).to(tdt)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    xf = x.float()
    mean = xf.mean((0, 2))
    invstd = torch.rsqrt(xf.var((0, 2), correction=0) + 1e-5)
    xn, gn = xf.numpy(), g.float().numpy()
    got = _mirror_bn_bwd_sums(gn, xn, mean.numpy(), invstd.numpy(), V)
    plain = tbnk.bn_bwd_stats_plain(g, x, mean, invstd)
    pallas = jbn.bn_bwd_stats(
        jnp.asarray(np.swapaxes(gn, 1, 2).reshape(-1, C), jnp.dtype(dtype)),
        jnp.asarray(np.swapaxes(xn, 1, 2).reshape(-1, C), jnp.dtype(dtype)),
        jnp.asarray(mean.numpy()), jnp.asarray(invstd.numpy()),
        block_rows=256, interpret=True)
    for k in range(2):
        np.testing.assert_allclose(got[k], plain[k].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[k], np.asarray(pallas[k]), rtol=1e-5,
                                   atol=1e-4)
    # dx from the mirrored sums, rounded once to the inputs' type
    dx = torch.from_numpy(_mirror_dx(gn, xn, scale.numpy(), mean.numpy(),
                                     invstd.numpy(), got[0], got[1])).to(tdt)
    want = tbnk.bn_bwd_plain(g, x, scale, mean, invstd)[0]
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(dx.float().numpy(), want.float().numpy(), **tol)


# --- the GOD training shape (64, 320, 24) -----------------------------------

@pytest.mark.parametrize("dtype,V", [("float32", 4), ("bfloat16", 8)])
def test_god_shape_walks_cover_every_vector_once(dtype, V):
    """Rows of 24: 6 (f32) or 3 (bf16) 16-byte vectors, 384 / 192 of a
    channel — fewer than a CTA's threads, so most threads load nothing.
    bn_stats' walk and the chosen bn_bwd kernel's walk each cover every
    vector once; the f32 register kernel uses one of its slots."""
    B, tv = 64, 24 // V
    n = B * tv
    seen = np.zeros(n, np.int64)
    for t in range(_threads()):
        for i in _thread_walk(n, t, _threads()):
            seen[i] += 1
    assert (seen == 1).all()
    threads = _bwd_threads()
    kernel, nv = _bwd_pick(B, 24, dtype)
    loaded = np.zeros(n, np.int64)
    if kernel == "registers":
        assert n <= threads < nv * threads  # one slot of twelve
        for t in range(threads):
            for m in range(nv):
                if t + m * threads < n:
                    loaded[t + m * threads] += 1
    else:
        drow, dcol = divmod(threads, tv)
        for t in range(threads):
            row, col = divmod(t, tv)
            for i in range(t, n, threads):
                assert (row, col) == divmod(i, tv)
                loaded[i] += 1
                row, col = _step(row, col, drow, dcol, tv)
    assert (loaded == 1).all()


@pytest.mark.parametrize("dtype,V", [("float32", 4), ("bfloat16", 8)])
def test_god_shape_sums_and_dx_in_kernel_order_match_plain_and_pallas(dtype, V):
    """bn_stats' sums and bn_bwd's sums and dx at B = 64, T = 24 (two of the
    320 channels), in the kernels' order, against the plain versions and the
    Pallas kernels (interpret mode), at the tolerances of the module
    docstring."""
    B, C, T = 64, 2, 24
    rng = np.random.RandomState(24)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy((rng.randn(B, C, T) * 3 + 1.5).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.randn(B, C, T).astype(np.float32)).to(tdt)
    xn, gn = x.float().numpy(), g.float().numpy()
    x2d = lambda a: jnp.asarray(np.swapaxes(a, 1, 2).reshape(-1, C), jnp.dtype(dtype))
    stats = _mirror_bn_stats(xn, V)
    plain = tbnk.bn_stats_plain(x)
    pallas = jbn.bn_stats(x2d(xn), block_rows=256, interpret=True)
    for k in range(2):
        np.testing.assert_allclose(stats[k], plain[k].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(stats[k], np.asarray(pallas[k]), rtol=1e-5,
                                   atol=1e-4)
    mean = torch.from_numpy(stats[0] / (B * T))
    invstd = torch.rsqrt(torch.from_numpy(stats[1] / (B * T)) - mean * mean + 1e-5)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    sums = _mirror_bn_bwd_sums(gn, xn, mean.numpy(), invstd.numpy(), V)
    plain = tbnk.bn_bwd_stats_plain(g, x, mean, invstd)
    pallas = jbn.bn_bwd_stats(x2d(gn), x2d(xn), jnp.asarray(mean.numpy()),
                              jnp.asarray(invstd.numpy()), block_rows=256,
                              interpret=True)
    for k in range(2):
        np.testing.assert_allclose(sums[k], plain[k].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(sums[k], np.asarray(pallas[k]), rtol=1e-5,
                                   atol=1e-4)
    dx = torch.from_numpy(_mirror_dx(gn, xn, scale.numpy(), mean.numpy(),
                                     invstd.numpy(), sums[0], sums[1])).to(tdt)
    want = tbnk.bn_bwd_plain(g, x, scale, mean, invstd)[0]
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    np.testing.assert_allclose(dx.float().numpy(), want.float().numpy(), **tol)


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
