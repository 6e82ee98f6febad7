"""Port kernels (meg_decoding_tpu_torch/ops/kernels/) against the JAX Pallas
kernels they replace, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there); here each wrapper takes its plain PyTorch
version because the tensors lie on the CPU.  The JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas.py does.

Tolerances: the gather is a copy — bit-exact.  The percentiles are exact
order statistics blended as fma(v_lo, w_lo, v_hi·w_hi) on both sides —
≤ 1 ulp (the plain version forms that FMA in f64, which can round
differently when the f64 sum lands on an f32 rounding midpoint).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meg_decoding_tpu.ops.pallas import quantile as jq
from meg_decoding_tpu.ops.pallas import window_gather as jwg
from meg_decoding_tpu_torch.ops.kernels import build
from meg_decoding_tpu_torch.ops.kernels import quantile as tq
from meg_decoding_tpu_torch.ops.kernels import window_gather as twg


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in f32 ulps (ordered int32 keys); NaN == NaN."""
    ka = a.astype(np.float32).view(np.int32).astype(np.int64)
    kb = b.astype(np.float32).view(np.int32).astype(np.int64)
    ka = np.where(ka < 0, -(ka & 0x7FFFFFFF), ka)
    kb = np.where(kb < 0, -(kb & 0x7FFFFFFF), kb)
    both_nan = np.isnan(a) & np.isnan(b)
    return int(np.max(np.where(both_nan, 0, np.abs(ka - kb)), initial=0))


# --- window_gather ---------------------------------------------------------

GATHER_CASES = {
    # onsets crossing 16-byte and 128-lane boundaries
    "lane_crossing": dict(seed=0, R=5, C=16, T0=900, L=96,
                          rec=[4, 0, 2, 2, 1, 3], on=[0, 1, 127, 128, 555, 804],
                          out_dtype=None),
    # an onset far past the end and a negative one: clamped to
    # [0, T - padded_window(L)], not [0, T - L]
    "out_of_range": dict(seed=1, R=2, C=8, T0=500, L=64, rec=[0, 1, 1],
                         on=[10**6, -5, 3], out_dtype=None),
    "bf16_out_dtype": dict(seed=2, R=3, C=16, T0=700, L=96,
                           rec=[2, 0, 1, 2], on=[3, 130, 0, 411],
                           out_dtype="bf16"),
    # length not a multiple of 4 (the kernel's scalar variant)
    "odd_length": dict(seed=3, R=2, C=5, T0=300, L=37, rec=[1, 0],
                       on=[7, 250], out_dtype=None),
}


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_window_gather_matches_jax_bit_exact(case):
    p = GATHER_CASES[case]
    rng = np.random.RandomState(p["seed"])
    T = jwg.pad_time_for_gather(p["T0"], p["L"])
    assert T == twg.pad_time_for_gather(p["T0"], p["L"])
    src = rng.randn(p["R"], p["C"], T).astype(np.float32)
    rec = np.asarray(p["rec"], np.int32)
    on = np.asarray(p["on"], np.int32)
    jdt = jnp.bfloat16 if p["out_dtype"] else None
    tdt = torch.bfloat16 if p["out_dtype"] else None
    want = jwg.window_gather(jnp.asarray(src), jnp.asarray(rec),
                             jnp.asarray(on), p["L"], interpret=True,
                             out_dtype=jdt)
    got = twg.window_gather(torch.from_numpy(src), torch.from_numpy(rec),
                            torch.from_numpy(on), p["L"], out_dtype=tdt)
    assert got.dtype == (tdt or torch.float32)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))


def test_window_gather_clamps_to_padded_window_bound():
    L = 360
    T = twg.pad_time_for_gather(2000, L)
    src = torch.arange(T, dtype=torch.float32).repeat(1, 2, 1)  # (1, 2, T)
    out = twg.window_gather(src, torch.tensor([0]), torch.tensor([10**6]), L)
    assert twg.padded_window(L) == 512
    assert out[0, 0, 0].item() == T - 512  # not T - L


@pytest.mark.parametrize("L", [1, 96, 128, 129, 360])
def test_padded_window_matches_jax(L):
    assert twg.padded_window(L) == jwg.padded_window(L)
    assert twg.pad_time_for_gather(1000, L) == jwg.pad_time_for_gather(1000, L)


def test_window_gather_rejects_short_source():
    with pytest.raises(ValueError, match="pad_time_for_gather"):
        twg.window_gather(torch.zeros(1, 2, 100), torch.tensor([0]),
                          torch.tensor([0]), 96)


# --- robust_quantiles ------------------------------------------------------

def _hard_rows(T: int, rng) -> np.ndarray:
    """Rows with NaN (both signs), ±inf, ±0, constants and duplicates."""
    x = (rng.randn(48, T) * rng.lognormal(size=(48, 1))).astype(np.float32)
    x[0] = x[0][0]                                   # constant row
    if T > 4:
        x[1, : T // 2], x[1, T // 2:] = 3.0, -2.0    # heavy duplicates
        x[2, ::3] = np.nan                           # +NaN
        x[3, ::4] = -np.float32(np.nan)              # -NaN sorts below -inf
        x[4, ::2], x[4, 1::2] = np.inf, -np.inf
        x[5, ::2], x[5, 1::2] = 0.0, -0.0            # signed zeros
        x[6, : T // 3] = -0.0
        x[7] = np.round(x[7])                        # many ties
        x[8, :3] = [np.inf, -np.inf, np.nan]
    return x


@pytest.mark.parametrize("T", [360, 7, 1, 2, 100, 201])
def test_robust_quantiles_matches_jax_within_1ulp(T):
    x = _hard_rows(T, np.random.RandomState(T))
    want = np.asarray(jq.robust_quantiles(jnp.asarray(x), interpret=True))
    got = tq.robust_quantiles(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (48, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert _ulp_diff(got, want) <= 1


def test_robust_quantiles_sorts_nan_and_signed_zero_like_xla():
    """The key order puts -NaN first and -0 below +0; a float sort would not."""
    x = np.array([[-np.float32(np.nan), 1.0, 2.0, 3.0, 4.0],
                  [0.0, -0.0, -0.0, 0.0, 0.0]], np.float32)
    got = tq.robust_quantiles(torch.from_numpy(x)).numpy()
    assert got[0, 0] == 1.0 and got[0, 1] == 2.0 and got[0, 2] == 3.0
    assert np.signbit(got[1, 0]) and not np.signbit(got[1, 2])


def test_ranks_and_weights_round_to_f32():
    (r, w_lo, w_hi, interp), = tq.ranks_and_weights(360, (25.0,))
    assert (r, interp) == (89, True)
    assert w_lo == float(np.float32(0.25)) and w_hi == float(np.float32(0.75))
    assert tq.ranks_and_weights(201, (50.0,))[0][3] is False


# --- routing: CPU → plain version, anything else → kernel or raise -----------

def test_wrappers_raise_on_a_device_without_kernel():
    """A tensor that is neither on CUDA nor on the CPU is refused, never
    quietly computed by the plain version."""
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.robust_quantiles(x)
    src = torch.empty(2, 3, 1024, device="meta")
    ids = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        twg.window_gather(src, ids, ids, 96)


def test_cpu_calls_do_not_count_as_launches():
    tq.reset_launches()
    twg.reset_launches()
    tq.robust_quantiles(torch.randn(3, 9))
    T = twg.pad_time_for_gather(64, 8)
    twg.window_gather(torch.randn(1, 2, T), torch.tensor([0]),
                      torch.tensor([0]), 8)
    assert tq.launches == 0 and twg.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing toolkit is an error, not a fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_targets_hopper_from_repo_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name in build.KERNELS:
        src, lib = build._lib_path(name)
        assert src.startswith(build.CSRC_DIR) and lib.startswith(build.BUILD_DIR)
        text = open(src).read()
        assert 'extern "C"' in text and "cudaGetLastError" in text


def test_integral_rank_over_infinities_follows_the_pallas_kernel():
    """At an integral rank (frac = 0) the Pallas kernel returns the order
    statistic itself; the JAX sort path's blend ``v·1 + v·0`` turns an
    infinite one into NaN.  The port follows the kernel."""
    from meg_decoding_tpu.ops.scaling import robust_stats as jstats

    x = np.array([[1.0, np.inf, np.inf, np.inf, np.inf]], np.float32)
    want = np.asarray(jq.robust_quantiles(jnp.asarray(x), interpret=True))
    got = tq.robust_quantiles(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got).all()
    med_sort, _ = jstats(jnp.asarray(x), impl="sort")
    assert np.isnan(np.asarray(med_sort)).all()  # the JAX backends disagree
