"""The erf_poly GELU's kernels (``csrc/gelu_erf_poly.cu``, wrapper
``ops/kernels/gelu.py``) on the CPU.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain op chain there).  Here: the wrapper's routing (CPU tensors take the
plain chain and count no launch; other dtypes and devices raise), the
source's place in the build, the names the profiler sorts the kernels by,
the shapes and layouts the model hands the wrapper, and the kernel's own
arithmetic, mirrored in numpy with the constants read from the source and
held against the plain chain.

Tolerances for the mirror: f32 rtol 2e-6 / atol 1e-6, as
tests/test_torch_port_modules.py holds the chain to JAX (the kernel's
Horner takes one fmaf a step where the chain rounds the product and the
sum apart, and its expf is not numpy's); bf16 at most 1 ulp (the f32
values, a few f32 ulp apart, may round to neighbouring bf16 values).
"""

import hashlib
import importlib
import os
import re

import numpy as np
import pytest
import torch

from meg_decoding_tpu_torch.cli.profile_train_step import kernel_group
from meg_decoding_tpu_torch.ops import gelu as tgelu
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import gelu as gk
from meg_decoding_tpu_torch.train import graph

SOURCE = "gelu_erf_poly"


def _source() -> str:
    with open(os.path.join(build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


def _float_const(name: str) -> np.float32:
    m = re.search(rf"constexpr float {name} = ([-+0-9.e]+)f;", _source())
    assert m, f"{name} not found in csrc/{SOURCE}.cu"
    return np.float32(float(m.group(1)))


def _float_table(name: str) -> np.ndarray:
    m = re.search(rf"constexpr float {name}\[(\d+)\] = \{{([^}}]*)\}};",
                  _source())
    assert m, f"{name} not found in csrc/{SOURCE}.cu"
    vals = [float(v.strip().rstrip("f")) for v in m.group(2).split(",")
            if v.strip()]
    assert len(vals) == int(m.group(1))
    return np.asarray(vals, np.float32)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        k = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(k < 0, -(k & 0x7FFF), k)
    return int((ordered(a) - ordered(b)).abs().max())


# --- routing: CPU → plain chain, anything else → kernel or raise -------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_chain_and_launch_nothing(dtype):
    gk.reset_launches()
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, 7, generator=gen) * 3).to(dtype)
    g = torch.randn(3, 5, 7, generator=gen).to(dtype)
    y = gk.gelu_fwd(x)
    assert y.dtype == dtype and torch.equal(y, gk.gelu_fwd_plain(x))
    assert torch.equal(gk.gelu_bwd(x, g), gk.gelu_bwd_plain(x, g))
    # the model's route: the autograd Function through the wrapper
    xr = x.clone().requires_grad_()
    out = tgelu.gelu(xr, "erf_poly")
    out.backward(g)
    assert torch.equal(out.detach(), y)
    assert torch.equal(xr.grad, gk.gelu_bwd_plain(x, g))
    assert gk.launches == {"gelu_fwd": 0, "gelu_bwd": 0}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32])
def test_an_unsupported_dtype_raises(dtype):
    x = torch.zeros(4, dtype=dtype)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gk.gelu_fwd(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gk.gelu_bwd(x, x)


def test_other_devices_and_mismatched_inputs_raise():
    """A tensor neither on CUDA nor on the CPU is refused, never quietly
    computed by the plain chain; the backward's two inputs must agree."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.gelu_fwd(x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gk.gelu_bwd(x, x)
    x = torch.zeros(4, 8)
    for g in (torch.zeros(8, 4), torch.zeros(4, 8, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="differ in shape, dtype or device"):
            gk.gelu_bwd(x, g)


def test_the_module_imports_and_computes_without_nvcc(monkeypatch):
    """Nothing is built at import or for a CPU tensor: with no toolkit to
    find, the module reloads and the model's GELU runs on the CPU."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    importlib.reload(gk)
    try:
        x = torch.linspace(-4, 4, 33)
        assert torch.equal(gk.gelu_fwd(x), gk.gelu_fwd_plain(x))
        assert gk._FNS == {}
    finally:
        importlib.reload(gk)


# --- the build and the profile's names ------------------------------------------

def test_the_source_is_built_with_the_others():
    assert SOURCE in build.KERNELS
    src, lib = build._lib_path(SOURCE)
    assert src == os.path.join(build.CSRC_DIR, f"{SOURCE}.cu")
    h = hashlib.sha256(open(src, "rb").read())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    assert lib == os.path.join(build.BUILD_DIR,
                               f"lib{SOURCE}-{h.hexdigest()[:16]}.so")
    text = _source()
    for fn in ("gelu_erf_poly_fwd_launch", "gelu_erf_poly_bwd_launch"):
        assert f'extern "C" int {fn}(' in text
    assert text.count("cudaGetLastError()") >= 2


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")


def test_kernel_names_sort_into_the_elementwise_group():
    """The profile (and the benchmark's trace, whose groups are the same)
    puts the GELU kernels with the pointwise ops, none of them under a
    hand-written kernel's, a convolution's or a reduction's name."""
    names = _GLOBAL.findall(_source())
    assert sorted(names) == ["gelu_erf_poly_elementwise_bwd_kernel",
                             "gelu_erf_poly_elementwise_fwd_kernel"]
    for name in names:
        for dtype in ("float", "__nv_bfloat16"):
            full = (f"void (anonymous namespace)::{name}<{dtype}>"
                    f"({dtype} const*, {dtype}*, long, long)")
            assert kernel_group(full) == "elementwise", full
        for word in ("conv", "norm", "reduce", "gemm", "sm90", "cutlass",
                     "quantile", "bn_", "fprop"):
            assert word not in name


def test_graph_replays_credit_the_gelu_counters():
    before = graph.launch_counts()
    key = ("gelu", "launches", "gelu_fwd")
    assert key in before and ("gelu", "launches", "gelu_bwd") in before
    graph._add_counts({key: 12})
    try:
        assert gk.launches["gelu_fwd"] == before[key] + 12
    finally:
        graph._add_counts({key: -12})


# --- what the model hands the wrapper -----------------------------------------

def _loc(n=12, seed=0):
    loc = np.random.RandomState(seed).rand(n, 2).astype(np.float32)
    return (loc - loc.min(0)) / (loc.max(0) - loc.min(0)) * 0.8 + 0.1


@pytest.mark.parametrize("kind", ["seq2seq", "pooled", "seq2static"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_every_call_site_passes_contiguous_tensors(monkeypatch, kind, dtype):
    """Every GELU of a training forward and backward reaches the wrapper
    with a contiguous x (a BN or convolution output) and, after the
    Function's ``contiguous()``, a contiguous g of x's shape and dtype;
    one forward and one backward launch a site."""
    from meg_decoding_tpu_torch.models.brain_encoder import (
        BrainEncoder,
        BrainEncoderSeq2Static,
    )

    seen = {"fwd": [], "bwd": []}
    fwd, bwd = gk.gelu_fwd, gk.gelu_bwd

    def spy_fwd(x):
        seen["fwd"].append((x.is_contiguous(), tuple(x.shape), x.dtype))
        return fwd(x)

    def spy_bwd(x, g):
        seen["bwd"].append((x.is_contiguous() and g.is_contiguous(),
                            g.shape == x.shape and g.dtype == x.dtype))
        return bwd(x, g)

    monkeypatch.setattr(tgelu, "gelu_fwd", spy_fwd)
    monkeypatch.setattr(tgelu, "gelu_bwd", spy_bwd)
    torch.manual_seed(0)
    C, T, S = 12, 40, 3
    common = dict(D1=8, D2=16, F=8, K=2, dtype=dtype, gelu_impl="erf_poly",
                  device="cpu")
    if kind == "seq2static":
        model = BrainEncoderSeq2Static(_loc(C), S, ks_list=[3] * 5, **common)
        sites = 2 * 5 + 2
    else:
        model = BrainEncoder(_loc(C), S, seq2seq=kind == "seq2seq",
                             num_blocks=2, **common)
        sites = 2 * 2 + 2
    model.train()
    X = torch.randn(4, C, T)
    out = model(X, torch.tensor([0, 1, 2, 0]), centre=0)
    (out.float() * torch.randn(out.shape)).sum().backward()
    assert len(seen["fwd"]) == sites and len(seen["bwd"]) == sites
    assert all(ok for ok, _, _ in seen["fwd"]), seen["fwd"]
    assert all(a and b for a, b in seen["bwd"]), seen["bwd"]
    assert {dt for _, _, dt in seen["fwd"]} == {dtype or torch.float32}


# --- the kernel's arithmetic, mirrored --------------------------------------

def test_the_source_holds_the_plain_chains_constants():
    f32 = lambda v: np.asarray(v, np.float32)
    np.testing.assert_array_equal(_float_table("kP"), f32(gk._P))
    np.testing.assert_array_equal(_float_table("kM"), f32(gk._M))
    np.testing.assert_array_equal(_float_table("kT"), f32(gk._T))
    for name, want in (("kSqrtHalf", gk._SQRT_HALF),
                       ("kInvSqrt2Pi", gk._INV_SQRT_2PI), ("kUMax", gk._UMAX),
                       ("kB1", gk._B1), ("kC1", gk._C1), ("kC2", gk._C2)):
        assert _float_const(name) == np.float32(want), name


def _fmaf(a, b, c):
    """f32 fma: the product of two f32 values is exact in f64; the f64 sum
    rounded to f32 (a double rounding, at most 1 ulp off a true fma in
    rare ties, inside the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _horner(c: np.ndarray, x: np.ndarray) -> np.ndarray:
    acc = np.full_like(x, c[-1])
    for ci in c[-2::-1]:
        acc = _fmaf(acc, x, np.float32(ci))
    return acc


def _erf_mirror(u: np.ndarray) -> np.ndarray:
    """erf_poly as the kernel takes it: each value its own interval's
    polynomial, chosen in the kernel's order (|u| > kUMax first, so a NaN
    reaches T₈), Horner by fmaf."""
    kP, kM, kT = _float_table("kP"), _float_table("kM"), _float_table("kT")
    umax, b1 = _float_const("kUMax"), _float_const("kB1")
    c1, c2 = _float_const("kC1"), _float_const("kC2")
    au = np.abs(u)
    mag = np.empty_like(u)
    hi = au > umax
    inner = ~hi & (au <= 1)
    mid = ~hi & ~inner & (au <= b1)
    tail = ~(hi | inner | mid)
    mag[hi] = 1
    a = au[inner]
    mag[inner] = a * _horner(kP, a * a)
    mag[mid] = _horner(kM, au[mid] - c1)
    mag[tail] = _horner(kT, au[tail] - c2)
    sign = np.where(u > 0, np.float32(1), np.where(u < 0, np.float32(-1),
                                                   np.float32(0)))
    return sign * mag


def _mirror(x: np.ndarray, g: np.ndarray) -> tuple:
    half = np.float32(0.5)
    e = _erf_mirror(x * _float_const("kSqrtHalf"))
    y = half * x * (np.float32(1) + e)
    cdf = half * (np.float32(1) + e)
    pdf = _float_const("kInvSqrt2Pi") * np.exp(-half * x * x)
    return y, _fmaf(x, pdf, cdf) * g


def _inputs(dtype) -> tuple:
    """Both signs across every interval and its edges, the values past
    kUMax, ±0 and ±inf: a dense sweep of [-7, 7] and values around each
    interval edge, with a cotangent of either sign."""
    edges = np.float32([1, 2.2, 3.92]) / np.float32(0.7071067811865476)
    near = (edges[:, None] * (1 + np.linspace(-1e-5, 1e-5, 41))[None]).ravel()
    x = np.concatenate([np.linspace(-7, 7, 200_001), near, -near,
                        [0.0, -0.0, np.inf, -np.inf, 12.0, -12.0]])
    g = np.cos(7 * np.clip(x, -12, 12)) * 2
    xt = torch.from_numpy(x.astype(np.float32)).to(dtype)
    gt = torch.from_numpy(g.astype(np.float32)).to(dtype)
    return xt, gt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_arithmetic_matches_the_plain_chain(dtype):
    x, g = _inputs(dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        y32, dx32 = _mirror(x.float().numpy(), g.float().numpy())
    want_y, want_dx = gk.gelu_fwd_plain(x), gk.gelu_bwd_plain(x, g)
    for got32, want in ((y32, want_y), (dx32, want_dx)):
        got = torch.from_numpy(got32).to(dtype)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        got, want = got[~nan], want[~nan]
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=2e-6, atol=1e-6)
        else:
            assert _bf16_ulps(got, want) <= 1
