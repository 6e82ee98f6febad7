"""Adam's multi-tensor kernel (``csrc/adam.cu``, wrapper
``ops/kernels/adam.py``), which ``train/optim.py:Adam.update`` calls.

* The planner: the slices of at most ``MAX_TENSORS`` tensors and their
  prefix sums of chunks, over a 0-dim tensor, odd and empty numels and a
  list that takes more than one launch.
* On the CPU ``Adam.update`` runs the plain chain, which must equal the
  per-parameter loop that ``Adam._update`` ran before the kernel
  (``_loop_update`` below) bit for bit: params, moments and count over 8
  steps of each schedule, with a skipped step and a None gradient.
* The table the wrapper hands the launcher (pointers, a null gradient,
  numels, prefix sums, the chunk size, the chain's constants), walked by
  a numpy mirror of the kernel (its binary search, chunks and arithmetic)
  that must give the plain chain's bits.
* The card's route: a strided gradient read through a contiguous copy,
  and a ValueError for a strided or non-f32 parameter or moment, a
  gradient of another dtype or device, or scalars of another kind.
* The source in the build, its sizes, its kernel's name in the profile's
  group "other"; ``adam.launches`` in ``_COUNTERS``.
* Marked ``card`` (skipped without an NVIDIA card; on the card: ``python
  -m pytest --noconftest tests/test_torch_port_adam_kernel.py -m card``):
  the kernel against the eager chain on the card, bit for bit, over 8
  steps (one skipped, one None gradient) at the speech and the GOD
  encoders' parameter lists and an off-path list, captured in a graph,
  with a strided gradient, and a bf16 list refused.

This file imports no JAX, so the card's tests run where JAX is absent.
"""

import hashlib
import math
import os
import re

import numpy as np
import pytest
import torch

from meg_decoding_tpu_torch.cli.profile_train_step import kernel_group
from meg_decoding_tpu_torch.core.config import Config
from meg_decoding_tpu_torch.ops import kernels
from meg_decoding_tpu_torch.ops.kernels import adam as ak
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.train.optim import Adam, AdamState
from meg_decoding_tpu_torch.train.schedules import make_optimizer

SOURCE = "adam"
SCHEDULES = {
    "none": {},
    "cosine": {},
    "multistep": {"lr_multistep_mlstns": [0.25, 0.5], "lr_step_gamma": 0.5},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return "cuda"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _source() -> str:
    with open(os.path.join(build.CSRC_DIR, f"{SOURCE}.cu")) as f:
        return f.read()


@torch.no_grad()
def _loop_update(schedule, params, grads, state: AdamState, ok) -> None:
    """``Adam._update`` as it was before the kernel: a loop of eager ops a
    parameter."""
    B1, B2, EPS = 0.9, 0.999, 1e-8
    neg_lr = -schedule(state.count)
    count_inc = state.count + 1
    c1 = 1 - B1 ** count_inc.to(torch.float32)
    c2 = 1 - B2 ** count_inc.to(torch.float32)
    for name, p in params.items():
        g = grads.get(name)
        if g is None:
            g = torch.zeros_like(p)
        mu, nu = state.mu[name], state.nu[name]
        mu_new = (1 - B1) * g + B1 * mu
        nu_new = (1 - B2) * (g * g) + B2 * nu
        u = (mu_new / c1) / (torch.sqrt(nu_new / c2) + EPS)
        p.copy_(torch.where(ok, p + u * neg_lr, p))
        mu.copy_(torch.where(ok, mu_new, mu))
        nu.copy_(torch.where(ok, nu_new, nu))
    state.count.copy_(torch.where(ok, count_inc, state.count))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32).cpu()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


# shapes of a small encoder's list: a 0-dim temperature, odd numels, a
# vector, and tensors of several chunks with and without a remainder
SHAPES = {"w": (3, 5), "b": (7,), "loss.temp": (), "big": (2, 4099),
          "even": (2, 2048), "odd": (4097,)}


def _params(device="cpu", shapes=SHAPES, seed=0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen).to(device)
            for k, s in shapes.items()}


def _grads(params: dict, step: int, none=("b",)) -> dict:
    """Gradients of mixed scales (a few exact zeros, subnormals and large
    values), None for the names in ``none``."""
    gen = torch.Generator().manual_seed(100 + step)
    out = {}
    for k, p in params.items():
        if k in none:
            out[k] = None
            continue
        g = torch.randn(p.shape, generator=gen) * 10.0 ** (step % 5 - 3)
        flat = g.reshape(-1)
        if flat.numel() > 3:
            flat[0], flat[1], flat[2] = 0.0, 1e-40, 3e4
        out[k] = g.to(p.device)
    return out


def _clone_state(state: AdamState) -> AdamState:
    return AdamState(mu={k: v.clone() for k, v in state.mu.items()},
                     nu={k: v.clone() for k, v in state.nu.items()},
                     count=state.count.clone())


# --- the planner ---------------------------------------------------------------

C = ak.CHUNK


@pytest.mark.parametrize("numels, want", [
    ([1], [(0, 1, [0, 1])]),                                 # a 0-dim tensor
    ([3, C, C + 1, 1], [(0, 4, [0, 1, 2, 4, 5])]),            # odd and exact
    ([0, 7, 0, 0, 2 * C + 1], [(0, 5, [0, 0, 1, 1, 1, 4])]),  # empty tensors
    ([0, 0], [(0, 2, [0, 0, 0])]),                           # nothing to launch
    ([], []),
], ids=["0dim", "odd", "empty", "all_empty", "no_tensor"])
def test_plan_gives_prefix_sums_of_chunks(numels, want):
    assert ak.plan(numels) == want


def test_plan_slices_a_long_list():
    """More tensors than a launch's table holds: one slice per
    ``MAX_TENSORS``, each with its own sums from 0."""
    n = 2 * ak.MAX_TENSORS + 5
    numels = [1 + (i * 997) % 9000 for i in range(n)]
    got = ak.plan(numels)
    assert [(lo, hi) for lo, hi, _ in got] == [
        (0, ak.MAX_TENSORS), (ak.MAX_TENSORS, 2 * ak.MAX_TENSORS),
        (2 * ak.MAX_TENSORS, n)]
    for lo, hi, starts in got:
        assert starts[0] == 0 and len(starts) == hi - lo + 1
        assert [b - a for a, b in zip(starts, starts[1:])] == [
            math.ceil(x / ak.CHUNK) for x in numels[lo:hi]]
    with pytest.raises(ValueError, match="numel"):
        ak.plan([4, -1])


def test_plan_of_the_encoders_lists_is_one_launch():
    """The speech and GOD encoders' parameter lists (and the temperature)
    fit one table."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    for C, S, F, seq2seq in ((208, 27, 1024, True), (22, 1, 512, False)):
        loc = np.random.RandomState(0).rand(C, 2).astype(np.float32)
        with torch.device("meta"):
            model = BrainEncoder(loc, S, D1=270, D2=320, F=F, K=32,
                                 seq2seq=seq2seq, num_blocks=5)
        numels = [p.numel() for p in model.parameters()] + [1]
        (lo, hi, starts), = ak.plan(numels)
        assert (lo, hi) == (0, len(numels)) and len(numels) <= ak.MAX_TENSORS
        assert starts[-1] == sum(math.ceil(n / ak.CHUNK) for n in numels)


# --- the plain route is the loop it replaced -----------------------------------

@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_plain_route_is_the_old_loop_bit_for_bit(kind):
    """Eight updates at 2 per epoch of a 4-epoch schedule on the CPU; the
    fourth is skipped (``ok`` false) and ``b`` has no gradient: params,
    moments and count equal the old loop's bit for bit, and every update
    took the chain and launched nothing."""
    conf = Config({"lr": 3e-3, "epochs": 4, "lr_scheduler": kind,
                   **SCHEDULES[kind]})
    adam = make_optimizer(conf, 2)
    params, ref = _params(), _params()
    state = adam.init(params)
    ref_state = _clone_state(state)
    ak.reset_launches()
    for i in range(8):
        grads = _grads(params, i)
        ok = torch.tensor(i != 3)
        adam.update(params, grads, state, ok)
        _loop_update(adam.schedule, ref, grads, ref_state, ok)
        for k in params:
            assert _same_bits(params[k], ref[k]), (i, k)
            assert _same_bits(state.mu[k], ref_state.mu[k]), (i, k)
            assert _same_bits(state.nu[k], ref_state.nu[k]), (i, k)
        assert torch.equal(state.count, ref_state.count)
    assert int(state.count) == 7
    assert ak.launches == {"multi_tensor": 0, "eager": 8}


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_other_dtypes_take_the_chain(dtype):
    params = {k: v.to(dtype) for k, v in _params().items()}
    state = Adam(lambda c: torch.full((), 1e-3)).init(params)
    ak.reset_launches()
    grads = {k: (None if g is None else g.to(dtype))
             for k, g in _grads(params, 1).items()}
    Adam(lambda c: torch.full((), 1e-3)).update(params, grads, state,
                                                 torch.tensor(True))
    assert ak.launches == {"multi_tensor": 0, "eager": 1}
    assert int(state.count) == 1


def test_mismatched_lists_raise():
    p = [torch.zeros(4)]
    s = [torch.zeros(()), torch.ones(()), torch.ones(()), torch.tensor(True)]
    with pytest.raises(ValueError, match="different lengths"):
        ak.adam_update(p, [], [torch.zeros(4)], [torch.zeros(4)], *s)
    with pytest.raises(ValueError, match="differs in size"):
        ak.adam_update(p, [torch.zeros(5)], [torch.zeros(4)], [torch.zeros(4)],
                       *s)


def test_the_cpu_route_never_loads_the_library(monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    params = _params()
    adam = Adam(lambda c: torch.full((), 1e-3))
    adam.update(params, _grads(params, 0), adam.init(params),
                torch.tensor(True))
    assert ak._FN == []


def _scalars(dev="cpu") -> tuple:
    return (torch.full((), -1e-3, device=dev), torch.full((), 0.1, device=dev),
            torch.full((), 1e-3, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))


def test_card_lists_copy_a_strided_gradient():
    """A strided gradient is read through a contiguous copy of the same
    values; a contiguous one and None are handed on as they are."""
    p = [torch.zeros(4, 6), torch.zeros(3), torch.zeros(5)]
    g_t = torch.randn(6, 4).t()
    g_c = torch.randn(3)
    got = ak.card_lists(p, [g_t, g_c, None], [torch.zeros_like(x) for x in p],
                        [torch.zeros_like(x) for x in p], _scalars(),
                        torch.device("cpu"))
    assert not g_t.is_contiguous() and got[0].is_contiguous()
    assert torch.equal(got[0], g_t) and got[1] is g_c and got[2] is None


def _bad_lists():
    """(what is wrong, params, grads, mus, nus, scalars) on the CPU."""
    p, g = torch.zeros(4, 6), torch.randn(4, 6)
    z = torch.zeros(4, 6)
    sc = _scalars()
    return {
        "strided_param": ([torch.zeros(6, 4).t()], [g], [z], [z], sc),
        "bf16_param": ([p.bfloat16()], [g], [z], [z], sc),
        "f64_moment": ([p], [g], [z.double()], [z], sc),
        "strided_moment": ([p], [g], [z], [torch.zeros(6, 4).t()], sc),
        "bf16_grad": ([p], [g.bfloat16()], [z], [z], sc),
        "grad_elsewhere": ([p], [torch.empty(4, 6, device="meta")], [z], [z],
                           sc),
        "param_elsewhere": ([torch.empty(4, 6, device="meta")], [g], [z], [z],
                            sc),
        "vector_lr": ([p], [g], [z], [z], (torch.full((1,), -1e-3),) + sc[1:]),
        "f64_c1": ([p], [g], [z], [z],
                   (sc[0], sc[1].double()) + sc[2:]),
        "float_ok": ([p], [g], [z], [z], sc[:3] + (torch.ones(()),)),
        "python_lr": ([p], [g], [z], [z], (-1e-3,) + sc[1:]),
    }


@pytest.mark.parametrize("what", sorted(_bad_lists()))
def test_card_lists_refuse_what_the_kernel_cannot_take(what):
    """What the kernel cannot read in place raises, so a layout mistake
    on the card fails instead of falling back to the chain unseen."""
    params, grads, mus, nus, sc = _bad_lists()[what]
    with pytest.raises(ValueError, match="adam_update"):
        ak.card_lists(params, grads, mus, nus, sc, torch.device("cpu"))


# --- the launcher's table, walked by a mirror of the kernel ---------------------

def _mirror(table: dict, tensors: dict) -> None:
    """The kernel in numpy on the recorded ``table`` (``tensors``: each
    pointer's tensor): for each CTA b the tensor by the same binary
    search, its chunk, the update of each value in the source's order with
    the launch's f32 constants, nothing where not ok."""
    k_1b1, k_b1, k_1b2, k_b2, k_eps = table["consts"]
    nlr, c1, c2, ok = (tensors[a].numpy()[()] for a in table["scalars"])
    if not ok:
        return
    n, starts = table["n"], table["start"]
    for b in range(starts[n]):
        lo, hi = 0, n
        while hi - lo > 1:
            mid = (lo + hi) >> 1
            lo, hi = (mid, hi) if starts[mid] <= b else (lo, mid)
        first = (b - starts[lo]) * table["chunk"]
        end = min(first + table["chunk"], table["numel"][lo])
        view = lambda a: tensors[a].numpy().reshape(-1)[first:end]  # noqa: E731
        p, mu, nu = view(table["p"][lo]), view(table["mu"][lo]), \
            view(table["nu"][lo])
        g = (np.zeros_like(p) if table["g"][lo] is None
             else view(table["g"][lo]))
        m = k_1b1 * g + k_b1 * mu
        v = k_1b2 * (g * g) + k_b2 * nu
        u = (m / c1) / (np.sqrt(v / c2) + k_eps)
        p[...] = p + u * nlr
        mu[...], nu[...] = m, v


def _record(monkeypatch) -> list:
    """Replace the launcher by a recorder of each launch's table."""
    calls = []

    def launcher(n, p, g, mu, nu, numel, start, chunk, omb1, b1, omb2, b2,
                 eps, neg_lr, c1, c2, ok, stream):
        # the constants as ctypes.c_float rounds them on the way in
        consts = tuple(np.float32(x) for x in (omb1, b1, omb2, b2, eps))
        calls.append({"n": n, "p": list(p[:n]), "g": list(g[:n]),
                      "mu": list(mu[:n]), "nu": list(nu[:n]),
                      "numel": list(numel[:n]), "start": list(start[:n + 1]),
                      "chunk": chunk, "consts": consts,
                      "scalars": (neg_lr, c1, c2, ok), "stream": stream})
        return 0

    monkeypatch.setattr(ak, "_FN", [launcher])
    return calls


@pytest.mark.parametrize("ok", [True, False])
@pytest.mark.parametrize("n_extra", [0, 100], ids=["one_slice", "two_slices"])
def test_the_kernels_table_and_arithmetic_give_the_chain(monkeypatch, ok,
                                                         n_extra):
    """The tables ``_launch`` hands the launcher for a list with a 0-dim
    tensor, odd numels, a None gradient, a base 4 bytes past an
    allocation's and (``two_slices``) 100 more small tensors, walked by
    the mirror, equal the plain chain bit for bit over 3 steps.  The chain
    takes an IEEE square root here, as on the card: torch's CPU sqrt is
    not correctly rounded on every CPU (its AVX-512 path is 1 ulp off for
    ~0.7 % of values), numpy's and CUDA's are."""
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float())
    shapes = dict(SHAPES, **{f"x{i}": (1 + 37 * i % 301,)
                             for i in range(n_extra)})
    gen = torch.Generator().manual_seed(7)
    params = _params(shapes=shapes)
    flat = torch.randn(1 + 4099, generator=gen)
    params["offset"] = flat[1:]  # contiguous, 4 bytes past its storage's base
    names = list(params)
    mus = [torch.randn(params[k].shape, generator=gen).abs() * 1e-2
           for k in names]
    nus = [torch.randn(params[k].shape, generator=gen).abs() * 1e-4
           for k in names]
    want_p = [params[k].clone() for k in names]
    want_mu, want_nu = [m.clone() for m in mus], [v.clone() for v in nus]
    calls = _record(monkeypatch)
    for step in range(3):
        grads = _grads(params, step, none=("b", "x3"))
        g = [grads[k] for k in names]
        count = torch.tensor(step + 1, dtype=torch.float32)
        neg_lr = -torch.full((), 3e-3)
        c1, c2 = 1 - ak.B1 ** count, 1 - ak.B2 ** count
        okt = torch.tensor(ok)
        del calls[:]
        ak._launch([params[k] for k in names], g, mus, nus, neg_lr, c1, c2,
                   okt, 1234)
        assert len(calls) == (1 if n_extra == 0 else 2)
        by_ptr = {t.data_ptr(): t for t in
                  ([params[k] for k in names] + mus + nus
                   + [x for x in g if x is not None]
                   + [neg_lr, c1, c2, okt])}
        for c in calls:
            assert c["chunk"] == ak.CHUNK and c["stream"] == 1234
            assert c["start"][0] == 0 and c["n"] <= ak.MAX_TENSORS
            assert c["consts"] == tuple(np.float32(x) for x in (
                1 - ak.B1, ak.B1, 1 - ak.B2, ak.B2, ak.EPS))
            assert [b - a for a, b in zip(c["start"], c["start"][1:])] == [
                math.ceil(n / ak.CHUNK) for n in c["numel"]]
        # the tables cover the list in order, a null pointer for None
        assert [ptr for c in calls for ptr in c["p"]] == \
            [params[k].data_ptr() for k in names]
        assert [ptr for c in calls for ptr in c["g"]] == \
            [None if x is None else x.data_ptr() for x in g]
        for c in calls:
            _mirror(c, by_ptr)
        ak.adam_update_plain(want_p, g, want_mu, want_nu, neg_lr, c1, c2, okt)
        for i, k in enumerate(names):
            assert _same_bits(params[k], want_p[i]), (step, k)
            assert _same_bits(mus[i], want_mu[i]), (step, k)
            assert _same_bits(nus[i], want_nu[i]), (step, k)
    assert ak.launches["multi_tensor"] >= 3


# --- what the training step hands the optimizer ---------------------------------

@pytest.mark.parametrize("kind", ["seq2seq", "pooled", "seq2static"])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_every_gradient_is_contiguous_f32(kind, dtype):
    """A training backward gives every parameter a contiguous f32 gradient
    (the bf16 stack's time-major convolutions too: ``_KrscWeight``), so the
    whole list takes the kernel on the card."""
    from meg_decoding_tpu_torch.models.brain_encoder import (
        BrainEncoder,
        BrainEncoderSeq2Static,
    )

    torch.manual_seed(0)
    C, T, S = 12, 40, 3
    loc = np.random.RandomState(0).rand(C, 2).astype(np.float32)
    common = dict(D1=8, D2=16, F=8, K=2, dtype=dtype, device="cpu")
    if kind == "seq2static":
        model = BrainEncoderSeq2Static(loc, S, ks_list=[3] * 5, **common)
    else:
        model = BrainEncoder(loc, S, seq2seq=kind == "seq2seq", num_blocks=2,
                             **common)
    model.train()
    out = model(torch.randn(4, C, T), torch.tensor([0, 1, 2, 0]), centre=0)
    params = list(model.parameters())
    grads = torch.autograd.grad((out.float() * torch.randn(out.shape)).sum(),
                                params)
    for p, g in zip(params, grads):
        assert p.dtype == g.dtype == torch.float32
        assert p.is_contiguous() and g.is_contiguous() and g.shape == p.shape


def test_time_major_weight_gradient_keeps_its_values():
    """``_KrscWeight``'s gradient is autograd's cast of the same values,
    bit for bit, in the parameter's layout."""
    from meg_decoding_tpu_torch.models.layers import _KrscWeight

    gen = torch.Generator().manual_seed(3)
    w = torch.randn(5, 7, 3, generator=gen, requires_grad=True)
    x = torch.randn(2, 7, 1, 11, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    gy = torch.randn(2, 5, 1, 11, generator=gen).to(torch.bfloat16)
    ours = _KrscWeight.apply(w, torch.bfloat16)
    theirs = w.transpose(1, 2).to(
        torch.bfloat16, memory_format=torch.contiguous_format).transpose(1, 2)
    assert torch.equal(ours, theirs) and ours.stride() == theirs.stride()
    g_ours, = torch.autograd.grad(
        torch.nn.functional.conv2d(x, ours.unsqueeze(2), padding="same"), w, gy)
    g_theirs, = torch.autograd.grad(
        torch.nn.functional.conv2d(x, theirs.unsqueeze(2), padding="same"), w,
        gy)
    assert g_ours.is_contiguous() and torch.equal(g_ours, g_theirs)


# --- the source, the build, the profile's names, the counter -----------------

def test_the_source_is_built_with_the_others():
    assert SOURCE in build.KERNELS
    src, lib = build._lib_path(SOURCE)
    assert src == os.path.join(build.CSRC_DIR, f"{SOURCE}.cu")
    h = hashlib.sha256(open(src, "rb").read())
    h.update(" ".join(build.NVCC_FLAGS).encode())
    assert lib == os.path.join(build.BUILD_DIR,
                               f"lib{SOURCE}-{h.hexdigest()[:16]}.so")
    text = _source()
    assert 'extern "C" int adam_multi_tensor_launch(' in text
    assert "cudaGetLastError()" in text and "__grid_constant__" in text


def test_the_source_holds_the_wrappers_constants():
    """The chunk and table sizes the planner uses.  The chain's constants
    are the wrapper's alone: the source takes them with the launch, and
    rounds each operation on its own (no contraction into an FMA)."""
    src = _source()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) * int(consts["kVec"]) == ak.CHUNK
    assert int(consts["kMaxTensors"]) == ak.MAX_TENSORS
    assert not re.search(r"0\.9\b|0\.999|1e-8|constexpr (float|double)", src)
    assert "float one_minus_b1, float b1" in src
    body = src[src.index("void adam1("):src.index("void adam4(")]
    assert "fmaf" not in body and "__fma" not in body
    for op in ("__fmul_rn", "__fadd_rn", "__fdiv_rn", "__fsqrt_rn"):
        assert op in body


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")


def test_kernel_name_sorts_into_the_group_other():
    """The profile (and the benchmark's trace) puts the kernel in no group
    a ``train.*`` metric reads but the scope ``adam``, and outside the
    hand-written kernels whose bytes the roofline share counts."""
    names = _GLOBAL.findall(_source())
    assert names == ["adam_multi_tensor_kernel"]
    full = ("void (anonymous namespace)::adam_multi_tensor_kernel("
            "(anonymous namespace)::AdamTable, float const*, float const*, "
            "float const*, bool const*)")
    assert kernel_group(full) == "other"
    assert not re.search(r"window_gather|quantile|bn_stats\w*kernel|"
                         r"bn_bwd\w*kernel", full)


def test_the_counter_is_listed_and_reset():
    assert (ak, "launches") in kernels._COUNTERS
    counts = kernels.launch_counts()
    assert ("adam", "launches", "multi_tensor") in counts
    assert ("adam", "launches", "eager") in counts
    kernels.add_counts({("adam", "launches", "multi_tensor"): 3,
                        ("adam", "launches", "eager"): 2})
    assert ak.launches["multi_tensor"] >= 3 and ak.launches["eager"] >= 2
    kernels.reset_launches()
    assert ak.launches == {"multi_tensor": 0, "eager": 0}


# --- on the card ---------------------------------------------------------------

def _encoder_params(kind: str, device) -> dict:
    """The speech (``gwilliams_speech``) or GOD (``god_image``) encoder's
    parameters at the benchmark configurations' widths, and the
    temperature."""
    from meg_decoding_tpu_torch.models.brain_encoder import BrainEncoder

    C, S, F, seq2seq = {"speech": (208, 27, 1024, True),
                        "god": (22, 1, 512, False)}[kind]
    loc = np.random.RandomState(0).rand(C, 2).astype(np.float32)
    model = BrainEncoder(loc, S, D1=270, D2=320, F=F, K=32, seq2seq=seq2seq,
                         num_blocks=5, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    params = {k: p.detach() for k, p in model.named_parameters()}
    params["loss.temp"] = torch.tensor(5.1, device=device)
    return params


def _card_grads(params: dict, step: int, none: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1000 + step)
    out = {}
    for k, p in params.items():
        if k == none:
            out[k] = None
            continue
        g = torch.randn(p.shape, device="cuda", generator=gen)
        out[k] = g * 10.0 ** (step % 5 - 3)
    return out


def _kernel_against_chain(params: dict, none: str, steps: int = 8) -> None:
    """``Adam.update`` (the kernel) against the old loop on a clone, 8
    steps, the fourth skipped: bit for bit, one launch a step, no chain."""
    conf = Config({"lr": 3e-3, "epochs": 4, "lr_scheduler": "cosine"})
    adam = make_optimizer(conf, 2)
    ref = {k: v.clone() for k, v in params.items()}
    state = adam.init(params)
    ref_state = _clone_state(state)
    ak.reset_launches()
    for i in range(steps):
        grads = _card_grads(params, i, none)
        ok = torch.tensor(i != 3, device="cuda")
        adam.update(params, grads, state, ok)
        _loop_update(adam.schedule, ref, grads, ref_state, ok)
        torch.cuda.synchronize()
        for k in params:
            assert _same_bits(params[k], ref[k]), (i, k)
            assert _same_bits(state.mu[k], ref_state.mu[k]), (i, k)
            assert _same_bits(state.nu[k], ref_state.nu[k]), (i, k)
        assert torch.equal(state.count, ref_state.count)
    slices = len(ak.plan([p.numel() for p in params.values()]))
    assert ak.launches == {"multi_tensor": steps * slices, "eager": 0}
    assert int(state.count) == steps - 1


@pytest.mark.card
@pytest.mark.parametrize("kind", ["speech", "god"])
def test_kernel_is_the_chain_on_the_card(card, kind):
    params = _encoder_params(kind, card)
    _kernel_against_chain(params, none="subject_block.subject_layer.weight")


@pytest.mark.card
def test_kernel_is_the_chain_off_path_on_the_card(card):
    """Odd numels, a 0-dim tensor, a base 4 bytes past its allocation's
    (the scalar path), and 120 tensors (two launches a step)."""
    shapes = dict(SHAPES, **{f"x{i}": (1 + 37 * i % 301,) for i in range(114)})
    params = _params(card, shapes)
    flat = torch.randn(1 + 3 * 4096 + 5, device=card)
    params["offset"] = flat[1:]
    _kernel_against_chain(params, none="b")


@pytest.mark.card
def test_kernel_replays_in_a_graph_on_the_card(card):
    """The update captured in a CUDA graph: its table and scalar pointers
    are the capture's, and three replays equal three eager chain steps."""
    params = _encoder_params("god", card)
    adam = Adam(lambda c: 3e-3 * torch.ones((), device=c.device))
    ref = {k: v.clone() for k, v in params.items()}
    state = adam.init(params)
    ref_state = _clone_state(state)
    grads = _card_grads(params, 2, none="loss.temp")
    ok = torch.ones((), dtype=torch.bool, device=card)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the warm-up a capture needs
        adam.update(params, grads, state, ok)
    torch.cuda.current_stream().wait_stream(stream)
    _loop_update(adam.schedule, ref, grads, ref_state, ok)
    graph = torch.cuda.CUDAGraph()
    ak.reset_launches()
    with torch.cuda.graph(graph):
        adam.update(params, grads, state, ok)
    assert ak.launches == {"multi_tensor": 1, "eager": 0}
    for _ in range(3):
        graph.replay()
        _loop_update(adam.schedule, ref, grads, ref_state, ok)
    torch.cuda.synchronize()
    for k in params:
        assert _same_bits(params[k], ref[k]), k
        assert _same_bits(state.mu[k], ref_state.mu[k]), k
        assert _same_bits(state.nu[k], ref_state.nu[k]), k
    assert int(state.count) == int(ref_state.count) == 4


@pytest.mark.card
def test_kernel_reads_a_strided_gradient_on_the_card(card):
    """A transposed gradient takes the kernel through its contiguous copy
    and gives the chain's bits; one launch, no chain."""
    gen = torch.Generator(device=card).manual_seed(5)
    params = [torch.randn(48, 40, device=card, generator=gen),
              torch.randn(7, device=card, generator=gen)]
    grads = [torch.randn(40, 48, device=card, generator=gen).t() * 1e-3,
             torch.randn(7, device=card, generator=gen)]
    mus = [torch.rand(p.shape, device=card, generator=gen) * 1e-3
           for p in params]
    nus = [torch.rand(p.shape, device=card, generator=gen) * 1e-6
           for p in params]
    sc = _scalars(card)
    ref = [[t.clone() for t in ts] for ts in (params, mus, nus)]
    ak.reset_launches()
    ak.adam_update(params, grads, mus, nus, *sc)
    ak.adam_update_plain(*ref[:1], grads, *ref[1:], *sc)
    torch.cuda.synchronize()
    assert ak.launches == {"multi_tensor": 1, "eager": 0}
    for got, want in zip((params, mus, nus), ref):
        for a, b in zip(got, want):
            assert _same_bits(a, b)


@pytest.mark.card
def test_a_bf16_list_is_refused_on_the_card(card):
    params = [torch.zeros(8, device=card, dtype=torch.bfloat16)]
    grads = [torch.ones_like(params[0])]
    mus = [torch.zeros(8, device=card)]
    ak.reset_launches()
    with pytest.raises(ValueError, match="contiguous f32"):
        ak.adam_update(params, grads, mus, [torch.zeros(8, device=card)],
                       *_scalars(card))
    assert ak.launches == {"multi_tensor": 0, "eager": 0}
