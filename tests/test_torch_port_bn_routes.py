"""The BN kernels' launch rules and walks of ``csrc/batchnorm_stats.cu``,
mirrored in numpy on the CPU (the kernels run only on the card, where
``chip_smoke.py`` holds them against their plain versions).

* ``bn_stats``' launcher rule (``stats_route``, ``cluster_size``) and
  ``bn_bwd_dx``'s tiles a channel (``dx_tiles``) by
  shape, on an H100's 132 SMs, with the constants read from the source.
* The cluster route's walk (CTA rank r's thread t on loads r·kThreads + t,
  then k·kThreads on, kStatsUnroll at a time) and ``bn_bwd_dx``'s walk
  (tile·len + t + u·kDxThreads) each visit every load once, the division-
  free steps landing where a division would.
* The sums in the cluster route's order (each thread's loads in
  turn, f32 adds and fmas emulated in f64, each warp's shuffle tree, warp
  0's tree over the warps' sums, the cluster's CTAs in rank order) within
  rtol 1e-5 / atol 1e-4 of the plain version and the Pallas kernel in
  interpret mode (f32 sums taken in another order, as
  tests/test_torch_port_kernel_designs.py).
* dx written through the walk equals the mirror of ``dx_of`` on the whole
  tensor exactly (the walk's addressing), and that mirror equals
  ``bn_bwd_dx_plain`` on the CPU exactly (one rounding per step, in the
  plain version's order).
* The wrappers refuse bad sums, M <= 0 and wrong dtypes as before, run
  the plain versions on CPU tensors, and the forced-route entry refuses a
  CPU tensor.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meg_decoding_tpu.ops.pallas import batchnorm as jbn
from meg_decoding_tpu_torch.ops.kernels import batchnorm as tbnk
from meg_decoding_tpu_torch.ops.kernels import build

SMS = 132  # an H100 SXM's streaming multiprocessors
F32, F64 = np.float32, np.float64


def _source() -> str:
    with open(os.path.join(build.CSRC_DIR, "batchnorm_stats.cu")) as f:
        return f.read()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", _source())
    assert m, f"{name} not found in csrc/batchnorm_stats.cu"
    return int(m.group(1))


THREADS, UNROLL, MAX_CLUSTER = (_const("kThreads"), _const("kStatsUnroll"),
                                _const("kMaxCluster"))
DX_THREADS, DX_ELEMS, DX_BLOCKS = (_const("kDxThreads"), _const("kDxElems"),
                                   _const("kDxBlocksPerSm"))


# --- the launch rules --------------------------------------------------------

def _pow2_floor(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p


def _loads(B: int, T: int, dtype: str, aligned: bool = True) -> tuple[int, int]:
    """(a channel's loads n, values a load V) as the launcher counts them."""
    V = 4 if dtype == "float32" else 8
    vec = T % V == 0 and aligned
    return (B * (T // V), V) if vec else (B * T, 1)


def _loads_per_thread(n: int, threads: int) -> int:
    return min(UNROLL, max(1, -(-n // threads)))


def _unroll(u: int) -> int:
    """The kernel instantiated for u loads a thread: the least of 1, 2, 4."""
    return 1 if u <= 1 else 2 if u <= 2 else 4


def _cluster_size(C: int, n: int) -> int:
    k = min(_pow2_floor(2 * SMS // C), _pow2_floor(n // THREADS))
    return max(2, min(MAX_CLUSTER, k))


def _stats_plan(B: int, C: int, T: int, dtype: str,
                aligned: bool = True) -> tuple[str, int]:
    n, _ = _loads(B, T, dtype, aligned)
    if n > THREADS * UNROLL and C < 2 * SMS:
        return "cluster", _cluster_size(C, n)
    return "per_channel", THREADS


def _dx_loads(V: int) -> int:
    """dx_loads: a thread's loads of each of g and x."""
    return 4 if V == 1 else DX_ELEMS // V


def _dx_tiles(n: int, C: int, U: int) -> int:
    least = -(-n // (DX_THREADS * U))
    most = -(-n // DX_THREADS)
    fill = SMS * DX_BLOCKS // C
    return max(least, min(fill, most))


@pytest.mark.parametrize("B,C,T,dtype,aligned,want", [
    (64, 320, 360, "float32", True, ("per_channel", 512)),   # speech step
    (64, 320, 360, "bfloat16", True, ("per_channel", 512)),
    (256, 320, 360, "bfloat16", True, ("per_channel", 512)),  # presets
    (64, 320, 24, "float32", True, ("per_channel", 512)),    # GOD
    (64, 320, 24, "bfloat16", True, ("per_channel", 512)),
    (64, 16, 528, "float32", True, ("cluster", 8)),          # EEGNet bn1
    (64, 16, 528, "bfloat16", True, ("cluster", 8)),
    (64, 32, 24, "float32", True, ("per_channel", 512)),     # EEGNet bn2
    (64, 32, 12, "float32", True, ("per_channel", 512)),     # EEGNet bn3
    (64, 320, 48, "float32", True, ("per_channel", 512)),    # Seq2Static
    (64, 320, 48, "bfloat16", True, ("per_channel", 512)),
    (64, 320, 23, "float32", True, ("per_channel", 512)),    # unaligned rows
    (64, 320, 11, "float32", True, ("per_channel", 512)),
    (64, 320, 5, "float32", True, ("per_channel", 512)),
    (64, 1, 360, "float32", True, ("cluster", 8)),
    (64, 131, 528, "float32", True, ("cluster", 2)),
    (64, 133, 528, "float32", True, ("cluster", 2)),
    (64, 263, 528, "float32", True, ("cluster", 2)),         # under 2 a SM
    (64, 264, 528, "float32", True, ("per_channel", 512)),
    (64, 21, 37, "float32", True, ("cluster", 4)),           # 2,368 elements
    (64, 16, 24, "float32", False, ("per_channel", 512)),    # base unaligned
    (64, 16, 48, "float32", False, ("cluster", 4)),          # 3,072 elements
])
def test_bn_stats_launcher_picks_the_route_by_shape(B, C, T, dtype, aligned,
                                                    want):
    assert _stats_plan(B, C, T, dtype, aligned) == want


@pytest.mark.parametrize("B,C,T,dtype,want", [
    (64, 320, 360, "float32", (6, 960)),    # 5,760 loads: 4 a thread
    (64, 320, 360, "bfloat16", (6, 480)),   # 2,880 loads: 2 a thread
    (64, 320, 24, "float32", (1, 384)),     # GOD: one tile a channel
    (64, 320, 24, "bfloat16", (1, 192)),
    (64, 16, 528, "float32", (33, 256)),    # few channels: one wave
    (4, 320, 24, "float32", (1, 24)),
    (2, 8, 360, "float32", (1, 180)),
    (3, 320, 37, "float32", (1, 111)),      # unaligned: 4 elements a thread
    (64, 320, 37, "float32", (3, 790)),
])
def test_bn_bwd_dx_launcher_tiles_by_shape(B, C, T, dtype, want):
    n, V = _loads(B, T, dtype)
    tiles = _dx_tiles(n, C, _dx_loads(V))
    assert (tiles, -(-n // tiles)) == want


# --- the walks ----------------------------------------------------------------

def _step(row, col, drow, dcol, tv):
    row, col = row + drow, col + dcol
    return (row + 1, col - tv) if col >= tv else (row, col)


def _stats_walk(first: int, stride: int, n: int, tv: int, U: int) -> list:
    """stats_walk's loads (row·tv + col) in order, each checked against a
    division."""
    drow, dcol = divmod(stride, tv)
    row, col = divmod(first, tv)
    out, i = [], first
    while i < n:
        for u in range(U):
            if u * stride < n - i:
                assert (row, col) == divmod(i + u * stride, tv)
                out.append(row * tv + col)
            if u + 1 < U:
                row, col = _step(row, col, drow, dcol, tv)
        row, col = _step(row, col, drow, dcol, tv)
        i += U * stride
    return out


def _cluster_walks(n: int, tv: int, k: int) -> list:
    """Each (rank, thread)'s loads on the cluster route."""
    U = _unroll(_loads_per_thread(n, k * THREADS))
    return [[_stats_walk(r * THREADS + t, k * THREADS, n, tv, U)
             for t in range(THREADS)] for r in range(k)]


@pytest.mark.parametrize("C", [1, 16, 32])
@pytest.mark.parametrize("B,T,dtype", [(3, 40, "float32"), (2, 37, "bfloat16"),
                                       (64, 528, "float32"),
                                       (64, 1100, "float32")])
def test_cluster_walk_visits_every_load_once(C, B, T, dtype):
    n, V = _loads(B, T, dtype)
    tv = T // V if V > 1 else T
    seen = np.zeros(n, np.int64)
    for rank in _cluster_walks(n, tv, _cluster_size(C, n)):
        for loads in rank:
            np.add.at(seen, loads, 1)
    assert (seen == 1).all()


def _thread_sums(xc: np.ndarray, loads: list, V: int) -> tuple:
    """One thread's (Σx, Σx²) over its loads of channel rows xc (B, T)."""
    flat = xc.reshape(-1)
    a, q = F32(0), F32(0)
    for j in loads:
        for e in flat[j * V:(j + 1) * V]:
            a = F32(a + e)
            q = F32(F64(e) * F64(e) + F64(q))
    return a, q


def _tree(v: np.ndarray) -> np.float32:
    """A warp's shuffle-down tree: lane 0's sum of 32 lanes."""
    v = v.astype(F32).copy()
    for o in (16, 8, 4, 2, 1):
        v[:o] = v[:o] + v[o:2 * o]
    return v[0]


def _block_tree(per_thread: np.ndarray) -> np.float32:
    """block_sum2_tree: each warp's tree, then warp 0's tree over the warps'
    sums padded with zeros to 32 lanes."""
    warps = [_tree(w) for w in per_thread.reshape(-1, 32)]
    return _tree(np.array(warps + [0.0] * (32 - len(warps)), F32))


def _mirror_cluster(x: np.ndarray, V: int, k: int) -> np.ndarray:
    B, C, T = x.shape
    tv = T // V
    n = B * tv
    out = np.zeros((2, C), F32)
    for c in range(C):
        xc = x[:, c, :]
        parts = []
        for rank in _cluster_walks(n, tv, k):
            sums = np.array([_thread_sums(xc, loads, V) for loads in rank], F32)
            parts.append((_block_tree(sums[:, 0]), _block_tree(sums[:, 1])))
        a, q = F32(0), F32(0)
        for pa, pq in parts:  # rank order
            a, q = F32(a + pa), F32(q + pq)
        out[:, c] = a, q
    return out


@pytest.mark.parametrize("C", [1, 16, 32])
@pytest.mark.parametrize("route,k", [("cluster", 2), ("cluster", 4),
                                     ("cluster", 8)])
def test_route_sums_in_kernel_order_match_plain_and_pallas(C, route, k):
    B, T = 5, 48  # 60 loads of 4 f32 a channel
    rng = np.random.RandomState(C + k)
    x = (rng.randn(B, C, T) * 3 + 1.5).astype(F32)
    plain = tbnk.bn_stats_plain(torch.from_numpy(x))
    x2d = np.ascontiguousarray(np.swapaxes(x, 1, 2).reshape(-1, C))
    pallas = jbn.bn_stats(jnp.asarray(x2d), block_rows=256, interpret=True)
    for V in (4, 1):  # 16-byte loads, and rows not 16-byte aligned
        got = _mirror_cluster(x, V, k)
        for i in range(2):
            np.testing.assert_allclose(got[i], plain[i].numpy(), rtol=1e-5,
                                       atol=1e-4)
            np.testing.assert_allclose(got[i], np.asarray(pallas[i]),
                                       rtol=1e-5, atol=1e-4)


def _dx_walk(B: int, C: int, T: int, V: int) -> list:
    """(channel, load) of every load bn_bwd_dx's threads take, in order."""
    tv = T // V
    n = B * tv
    U = _dx_loads(V)
    tiles = _dx_tiles(n, C, U)
    length = -(-n // tiles)
    drow, dcol = divmod(DX_THREADS, tv)
    out = []
    for c in range(C):
        for tile in range(tiles):
            i0 = tile * length
            for t in range(DX_THREADS):
                left = min(n - i0, length) - t
                first = i0 + t
                row, col = divmod(first, tv)
                for u in range(U):
                    if u * DX_THREADS < left:
                        assert (row, col) == divmod(first + u * DX_THREADS, tv)
                        out.append((c, row * tv + col))
                    if u + 1 < U:
                        row, col = _step(row, col, drow, dcol, tv)
    return out


def _dx_of(g, x, scale, mean, invstd, sums, M):
    """dx_of on whole (B, C, T) f32 arrays: each step rounded on its own."""
    col = lambda v: np.asarray(v, F32)[None, :, None]
    Mf = F32(M)
    a = col(F32(scale) * F32(invstd))
    k1, k2 = col(sums[0] / Mf), col(sums[1] / Mf)
    xc = x - col(mean)
    xhat = xc * col(invstd)
    return a * ((g - k1) - xhat * k2)


@pytest.mark.parametrize("B,C,T", [(4, 320, 24), (2, 8, 360)])
@pytest.mark.parametrize("dtype,V", [("float32", 4), ("bfloat16", 8),
                                     ("float32", 1)])  # rows not aligned
def test_dx_walk_covers_each_load_once_and_writes_dx_of(B, C, T, dtype, V):
    rng = np.random.RandomState(B * T)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy((rng.randn(B, C, T) * 3 + 1.5).astype(F32)).to(tdt)
    g = torch.from_numpy(rng.randn(B, C, T).astype(F32)).to(tdt)
    scale = rng.uniform(0.5, 1.5, C).astype(F32)
    xn, gn = x.float().numpy(), g.float().numpy()
    mean = xn.mean((0, 2)).astype(F32)
    invstd = (1 / np.sqrt(xn.var((0, 2)) + 1e-5)).astype(F32)
    sums = np.stack([gn.sum((0, 2)), (gn * (xn - mean[:, None]) * invstd[:, None]).sum((0, 2))]).astype(F32)
    M = B * T
    whole = _dx_of(gn, xn, scale, mean, invstd, sums, M)
    # the walk: every 16-byte load once, dx written where it reads
    tv = T // V
    seen = np.zeros((C, B * tv), np.int64)
    dx = np.full_like(whole, np.nan)
    for c, j in _dx_walk(B, C, T, V):
        seen[c, j] += 1
        b, col = divmod(j, tv)
        sl = (b, c, slice(col * V, (col + 1) * V))
        dx[sl] = _dx_of(gn[sl][None, None], xn[sl][None, None], scale[c:c + 1],
                        mean[c:c + 1], invstd[c:c + 1], sums[:, c:c + 1], M)[0, 0]
    assert (seen == 1).all()
    np.testing.assert_array_equal(dx, whole)
    plain = tbnk.bn_bwd_dx_plain(g, x, torch.from_numpy(scale),
                                 torch.from_numpy(mean), torch.from_numpy(invstd),
                                 torch.from_numpy(sums), M)
    np.testing.assert_array_equal(torch.from_numpy(whole).to(tdt).float().numpy(),
                                  plain.float().numpy())


# --- the wrappers ---------------------------------------------------------------

def test_bn_bwd_dx_wrapper_refuses_bad_inputs():
    B, C, T = 2, 3, 8
    x = torch.randn(B, C, T)
    g = torch.randn(B, C, T)
    v = torch.ones(C)
    sums = torch.zeros(2, C)
    ok = tbnk.bn_bwd_dx(g, x, v, v, v, sums, B * T)
    assert ok.shape == x.shape and ok.dtype == x.dtype
    for bad in (torch.zeros(3, C), torch.zeros(2, C + 1), torch.zeros(C),
                torch.zeros(2, C, dtype=torch.float64),
                torch.zeros(2, C, dtype=torch.bfloat16),
                torch.zeros(2, C, device="meta")):
        with pytest.raises(ValueError, match="sums must be"):
            tbnk.bn_bwd_dx(g, x, v, v, v, bad, B * T)
    for M in (0, -1):
        with pytest.raises(ValueError, match="M must be positive"):
            tbnk.bn_bwd_dx(g, x, v, v, v, sums, M)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tbnk.bn_bwd_dx(g.double(), x.double(), v, v, v, sums, B * T)
    with pytest.raises(ValueError, match="differ"):
        tbnk.bn_bwd_dx(g.to(torch.bfloat16), x, v, v, v, sums, B * T)
    with pytest.raises(ValueError, match="scale"):
        tbnk.bn_bwd_dx(g, x, torch.ones(C + 1), v, v, sums, B * T)
    with pytest.raises(ValueError, match="gvar"):
        tbnk.bn_bwd_dx(g, x, v, v, v, sums, B * T, None, v.double())
    with pytest.raises(ValueError, match=r"\(B, C, T\)"):
        tbnk.bn_bwd_dx(g[0], x[0], v, v, v, sums, B * T)
    tbnk.reset_launches()
    tbnk.bn_bwd_dx(g, x, v, v, v, sums, B * T)
    tbnk.bn_stats(x)
    assert tbnk.dx_launches == 0  # CPU tensors: the plain versions
    assert tbnk.stats_route_launches == dict.fromkeys(tbnk.STATS_ROUTES, 0)


def test_forced_route_entry_refuses_cpu_tensors():
    x = torch.randn(2, 3, 8)
    for route in (None, *tbnk.STATS_ROUTES):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tbnk._bn_stats_route(x, route)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tbnk._bn_stats_route(x.double())
