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


# --- the time-major route ------------------------------------------------------

TM_THREADS, TM_SEGS = _const("kTmThreads"), _const("kTmSegs")
TM_CTAS = 2 * SMS  # resident at once: two CTAs of kTmThreads an SM


def _tm_plan(M: int, C: int, V: int, ctas: int = TM_CTAS) -> dict:
    """tm_coop_plan: whole rows a CTA where a row's loads fit kTmThreads
    channels, else tiles; chunks within the resident CTAs and the
    wrapper's workspace (4·SMs rows of (2, C)), none under one pass."""
    cv = C // V
    w = min(cv, TM_THREADS // V)
    tiles = -(-cv // w)
    R = TM_THREADS // w
    most = min(ctas // tiles, 4 * SMS - TM_SEGS)
    chunks = max(1, min(most, -(-M // R)))
    return {"w": w, "tiles": tiles, "R": R, "chunks": chunks,
            "len": -(-M // chunks)}


@pytest.mark.parametrize("M,C,dtype,aligned,want", [
    (256 * 360, 320, "bfloat16", True, (40, 1, 264, 350)),   # the presets
    (64 * 360, 320, "float32", True, (80, 1, 264, 88)),      # f32 step's
    (64 * 360, 320, "bfloat16", True, (40, 1, 264, 88)),
    (256 * 48, 320, "bfloat16", True, (40, 1, 264, 47)),     # Seq2Static
    (64 * 360, 21, "bfloat16", True, (21, 1, 264, 88)),      # C·2 B unaligned
    (64 * 360, 320, "bfloat16", False, (320, 1, 264, 88)),   # base unaligned
    (10, 1024, "bfloat16", True, (64, 2, 2, 5)),             # two tiles
    (3 * 37, 320, "float32", True, (80, 1, 19, 6)),          # few rows
    (1, 1, "float32", True, (1, 1, 1, 1)),
])
def test_time_major_launcher_plans_by_shape(M, C, dtype, aligned, want):
    V = 4 if dtype == "float32" else 8
    v = V if C % V == 0 and aligned else 1
    p = _tm_plan(M, C, v)
    assert (p["w"], p["tiles"], p["chunks"], p["len"]) == want
    assert p["chunks"] * p["tiles"] <= TM_CTAS  # the cooperative grid fits


def _tm_threads(M: int, C: int, V: int, p: dict):
    """Every (chunk, tile, thread) of the grid with its load, first row and
    row count, as tm_thread gives them (numpy arrays over the threads)."""
    w, R, L = p["w"], p["R"], p["len"]
    b, y, t = np.meshgrid(np.arange(p["chunks"]), np.arange(p["tiles"]),
                          np.arange(TM_THREADS), indexing="ij")
    b, y, t = b.ravel(), y.ravel(), t.ravel()
    row = t // w
    load = y * w + t % w
    active = (row < R) & (load * V < C)
    first = b * L + row
    end = np.minimum((b + 1) * L, M)
    n = np.where(active & (first < end), -(-(end - first) // R), 0)
    return b, y, t, load, first, n


@pytest.mark.parametrize("M,C,V,ctas", [(240, 32, 4, TM_CTAS), (240, 32, 4, 3),
                                        (111, 21, 1, 5), (16, 1024, 8, 4),
                                        (90, 16, 8, TM_CTAS)])
def test_time_major_walk_visits_every_load_once(M, C, V, ctas):
    p = _tm_plan(M, C, V, ctas)
    _, _, _, load, first, n = _tm_threads(M, C, V, p)
    seen = np.zeros((M, C // V), np.int64)
    for j in range(int(n.max())):
        on = j < n
        np.add.at(seen, (first[on] + j * p["R"], load[on]), 1)
    assert (seen == 1).all()


def _f32_fma(a, b, c):
    return F32(F64(a) * F64(b) + F64(c))


def _mirror_tm_stats(x: np.ndarray, V: int, ctas: int) -> np.ndarray:
    """bn_stats_tm_kernel's sums of x (M, C) f32 in the kernel's order: each
    thread's rows in turn (f32 adds, fmas emulated in f64), the CTA's R
    rows of a load in order, the chunks of each segment in order, then
    the segments in order."""
    M, C = x.shape
    p = _tm_plan(M, C, V, ctas)
    b, y, t, load, first, n = _tm_threads(M, C, V, p)
    xv = x.reshape(M, C // V, V)
    s = np.zeros((len(t), V), F32)
    ss = np.zeros((len(t), V), F32)
    for j in range(int(n.max()) if len(n) else 0):
        on = np.nonzero(j < n)[0]
        v = xv[first[on] + j * p["R"], load[on]]
        s[on] = (s[on] + v).astype(F32)
        ss[on] = _f32_fma(v, v, ss[on])
    w, R = p["w"], p["R"]
    part = np.zeros((p["chunks"], 2, C), F32)
    for chunk in range(p["chunks"]):
        for tile in range(p["tiles"]):
            sel = (b == chunk) & (y == tile)
            cs, css = s[sel], ss[sel]          # thread order
            tt = t[sel]
            for slot in range(w * V):
                c = tile * w * V + slot
                if c >= C:
                    continue
                a = q = F32(0)
                for r in range(R):             # rows of the CTA in order
                    k = r * w + slot // V
                    a, q = F32(a + cs[k, slot % V]), F32(q + css[k, slot % V])
                    assert tt[k] == k
                part[chunk, :, c] = a, q
    per = -(-p["chunks"] // TM_SEGS)
    segs = np.zeros((TM_SEGS, 2, C), F32)
    for sg in range(TM_SEGS):
        for chunk in range(sg * per, min(p["chunks"], (sg + 1) * per)):
            segs[sg] = (segs[sg] + part[chunk]).astype(F32)
    out = np.zeros((2, C), F32)
    for sg in range(TM_SEGS):
        out = (out + segs[sg]).astype(F32)
    return out


@pytest.mark.parametrize("C,V", [(16, 4), (32, 4), (21, 1), (16, 8)])
@pytest.mark.parametrize("ctas", [TM_CTAS, 3])
def test_time_major_sums_in_kernel_order_match_plain_and_pallas(C, V, ctas):
    B, T = 5, 48
    rng = np.random.RandomState(C + ctas)
    x = (rng.randn(B, T, C) * 3 + 1.5).astype(F32)
    got = _mirror_tm_stats(x.reshape(-1, C), V, ctas)
    plain = tbnk.bn_stats_plain(torch.from_numpy(x), time_major=True)
    pallas = jbn.bn_stats(jnp.asarray(x.reshape(-1, C)), block_rows=256,
                          interpret=True)
    for i in range(2):
        np.testing.assert_allclose(got[i], plain[i].numpy(), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(got[i], np.asarray(pallas[i]), rtol=1e-5,
                                   atol=1e-4)


@pytest.mark.parametrize("M,C,V", [(96, 320, 4), (720, 8, 8), (111, 21, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_major_dx_walk_writes_dx_of_on_every_element(M, C, V, dtype):
    """tm_dx_walk (each thread's rows, reversed or not) writes dx_of of
    each element it reads, once, which is bn_bwd_dx_plain's dx exactly on
    the time-major layout."""
    rng = np.random.RandomState(M + C)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy((rng.randn(1, M, C) * 3 + 1.5).astype(F32)).to(tdt)
    g = torch.from_numpy(rng.randn(1, M, C).astype(F32)).to(tdt)
    scale = rng.uniform(0.5, 1.5, C).astype(F32)
    xn, gn = x.float().numpy()[0], g.float().numpy()[0]
    mean = xn.mean(0).astype(F32)
    invstd = (1 / np.sqrt(xn.var(0) + 1e-5)).astype(F32)
    sums = np.stack([gn.sum(0), (gn * (xn - mean) * invstd).sum(0)]).astype(F32)
    whole = _dx_of(gn.T[None], xn.T[None], scale, mean, invstd, sums, M)[0].T
    p = _tm_plan(M, C, V, TM_CTAS)
    _, _, _, load, first, n = _tm_threads(M, C, V, p)
    dx = np.full_like(whole, np.nan)
    for j in range(int(n.max())):
        on = j < n
        rows = first[on] + j * p["R"]
        for e in range(V):
            cols = load[on] * V + e
            assert np.isnan(dx[rows, cols]).all()  # written once
            dx[rows, cols] = whole[rows, cols]
    assert not np.isnan(dx).any()
    plain = tbnk.bn_bwd_dx_plain(g, x, torch.from_numpy(scale),
                                 torch.from_numpy(mean),
                                 torch.from_numpy(invstd),
                                 torch.from_numpy(sums), M, time_major=True)
    np.testing.assert_array_equal(
        torch.from_numpy(whole[None]).to(tdt).float().numpy(),
        plain.float().numpy())


# the time-major plain versions against the NCW ones on the transposed input:
# the same values a channel, summed over another order of the same elements
# (f32 sums: within 1e-6 of Σ|term|); dx from the same sums exactly
@pytest.mark.parametrize("kernel,cot", [
    ("bn_stats", False), ("bn_bwd_stats", False), ("bn_bwd", False),
    ("bn_bwd", True), ("bn_bwd_dx", False), ("bn_bwd_dx", True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_major_plain_equals_ncw_on_the_transposed_input(kernel, cot,
                                                             dtype):
    B, T, C = 3, 40, 12
    rng = np.random.RandomState(B * T + C)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy((rng.randn(B, T, C) * 3 + 1.5).astype(F32)).to(tdt)
    g = torch.from_numpy(rng.randn(B, T, C).astype(F32)).to(tdt)
    scale, mean, gm, gv = (torch.from_numpy(rng.randn(C).astype(F32))
                           for _ in range(4))
    invstd = torch.from_numpy(rng.uniform(0.5, 2, C).astype(F32))
    cots = (gm, gv) if cot else (None, None)
    ncw = lambda t: t.transpose(1, 2)  # noqa: E731
    tot = lambda t: t.float().abs().sum((0, 1))  # noqa: E731
    if kernel == "bn_stats":
        got = tbnk.bn_stats_plain(x, time_major=True)
        want = tbnk.bn_stats_plain(ncw(x))
        scales = (tot(x), tot(x.float() ** 2))
    elif kernel == "bn_bwd_stats":
        got = tbnk.bn_bwd_stats_plain(g, x, mean, invstd, time_major=True)
        want = tbnk.bn_bwd_stats_plain(ncw(g), ncw(x), mean, invstd)
        scales = (tot(g), tot(g.float() * (x.float() - mean) * invstd))
    elif kernel == "bn_bwd":
        dx, *got = tbnk.bn_bwd_plain(g, x, scale, mean, invstd, *cots,
                                     time_major=True)
        wdx, *want = tbnk.bn_bwd_plain(ncw(g), ncw(x), scale, mean, invstd,
                                       *cots)
        scales = (tot(g), tot(g.float() * (x.float() - mean) * invstd))
        # dx from the NCW sums is the same elementwise arithmetic
        again = tbnk.bn_bwd_dx_plain(g, x, scale, mean, invstd,
                                     torch.stack(want), B * T, *cots,
                                     time_major=True)
        torch.testing.assert_close(ncw(again), wdx, rtol=0, atol=0)
        torch.testing.assert_close(ncw(dx), wdx, rtol=1e-5, atol=1e-5)
    else:
        sums = torch.from_numpy(rng.randn(2, C).astype(F32))
        got = tbnk.bn_bwd_dx_plain(g, x, scale, mean, invstd, sums, B * T,
                                   *cots, time_major=True)
        want = tbnk.bn_bwd_dx_plain(ncw(g), ncw(x), scale, mean, invstd, sums,
                                    B * T, *cots)
        assert got.shape == x.shape and got.dtype == x.dtype
        torch.testing.assert_close(ncw(got), want, rtol=0, atol=0)
        return
    for a, b, sc in zip(got, want, scales):
        assert bool(((a - b).abs() <= 1e-6 * sc).all())


def test_time_major_wrappers_run_the_plain_versions_on_cpu():
    B, T, C = 2, 8, 5
    x, g = torch.randn(B, T, C), torch.randn(B, T, C)
    v = torch.ones(C)
    tbnk.reset_launches()
    for a, b in zip(tbnk.bn_stats(x, time_major=True),
                    tbnk.bn_stats_plain(x, True)):
        assert torch.equal(a, b)
    for a, b in zip(tbnk.bn_bwd(g, x, v, v, v, time_major=True),
                    tbnk.bn_bwd_plain(g, x, v, v, v, time_major=True)):
        assert torch.equal(a, b)
    assert tbnk.bn_bwd_dx(g, x, v, v, v, torch.zeros(2, C), B * T,
                          time_major=True).shape == x.shape
    with pytest.raises(ValueError, match="sums must be"):
        tbnk.bn_bwd_dx(g, x, v, v, v, torch.zeros(2, T), B * T,
                       time_major=True)
    with pytest.raises(ValueError, match="scale"):
        tbnk.bn_bwd(g, x, torch.ones(T), v, v, time_major=True)
    with pytest.raises(ValueError, match=r"\(B, T, C\)"):
        tbnk.bn_stats(x[0], time_major=True)
    assert tbnk.launches == {"bn_stats": 0, "bn_bwd_stats": 0}
    assert tbnk.stats_route_launches == dict.fromkeys(tbnk.STATS_ROUTES, 0)
    assert tbnk.bwd_route_launches == dict.fromkeys(tbnk.BWD_ROUTES, 0)


def _fake_launches(monkeypatch):
    """The wrappers' card branch on CPU tensors: the check passes them, and
    each C entry is a stand-in that reports a route and writes nothing (the
    outputs stay uninitialised), so that the counters count what a step
    on the card would launch."""
    check = tbnk._check
    monkeypatch.setattr(tbnk, "_check",
                        lambda *a, **k: (check(*a, **k), False)[1])
    monkeypatch.setattr(tbnk, "_stream", lambda x: 0)
    monkeypatch.setattr(tbnk, "_workspace",
                        lambda x, C: torch.empty(4 * SMS * 2 * C))

    def entry(name):
        def launch(*args):
            if name in ("bn_stats_launch", "bn_bwd_launch"):
                args[-1]._obj.value = 0 if name == "bn_stats_launch" else 1
            return 0
        return launch

    monkeypatch.setattr(tbnk, "_fn", entry)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 10), (None, 0)])
def test_route_counters_read_ten_time_major_a_bf16_step(monkeypatch, dtype,
                                                        want):
    """A training forward and backward of the five-block encoder launches
    each BN kernel 10 times: all on the time-major route in bf16, none in
    f32 (the NCW routes instead)."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    torch.manual_seed(0)
    loc = np.random.RandomState(0).rand(6, 2).astype(F32)
    model = BrainEncoder(loc, 2, D1=8, D2=16, F=8, K=2, num_blocks=5,
                         seq2seq=True, dtype=dtype, device="cpu",
                         generator=torch.Generator().manual_seed(0)).train()
    X = torch.randn(2, 6, 24)
    subs = torch.tensor([0, 1])
    _fake_launches(monkeypatch)
    tbnk.reset_launches()
    out = model(X, subs, centre=1)
    out.float().sum().backward()
    assert tbnk.launches == {"bn_stats": 10, "bn_bwd_stats": 10}
    assert tbnk.stats_route_launches["time_major"] == want
    assert tbnk.bwd_route_launches["time_major"] == want
    assert tbnk.stats_route_launches["per_channel"] == 10 - want
    assert tbnk.bwd_route_launches["two_walk"] == 10 - want
    tbnk.reset_launches()
