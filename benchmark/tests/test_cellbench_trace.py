"""The trace arithmetic: busy union, idle gaps and shares, the kernel
groups, the per-layer readers on a made-up trace."""

import numpy as np
import pytest

from benchcore import trace as tr
from benchcore.spec import Spec


def test_busy_is_the_union_of_intervals():
    assert tr.busy([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert tr.busy([]) == 0


def test_idle_gaps_longest_first_and_clipped_to_the_window():
    gaps = tr.idle_gaps([(1, 2), (2, 3), (6, 7), (3.5, 4)], 0, 10)
    assert gaps == [(7, 10), (4, 6), (0, 1), (3, 3.5)]
    assert tr.idle_gaps([(0, 10)], 2, 8) == []


def test_kernel_groups_match_the_programs_table():
    from meg_decoding_tpu_torch.cli.profile_train_step import kernel_group

    names = ["bn_stats_kernel<float>", "bn_bwd_reg_kernel",
             "void window_gather_vec4<float>", "robust_quantiles_sort_kernel",
             "sm90_xmma_fprop_implicit_gemm", "cutlass_80_gemm",
             "reduce_kernel", "vectorized_elementwise_kernel",
             "Memcpy DtoD (Device -> Device)", "softmax_warp_forward"]
    for n in names:
        assert tr.kernel_group(n) == kernel_group(n)
    assert tr.hand_kernel("quantile_long_pass1_kernel") == "robust_quantiles"
    assert tr.hand_kernel("bn_bwd_l2_kernel<__nv_bfloat16>") == "bn_bwd"
    assert tr.hand_kernel("vectorized_elementwise_kernel") is None


def _trace():
    # a window of 100 us: two steps of a gather, a BN kernel, a conv and
    # an elementwise kernel; the device is busy 70 us of it
    dev = [("window_gather_vec4", 0, 5), ("bn_stats_kernel", 5, 15),
           ("sm90_xmma_fprop", 20, 40), ("vectorized_elementwise_kernel", 35, 45),
           ("window_gather_vec4", 60, 65), ("bn_stats_kernel", 65, 75),
           ("sm90_xmma_fprop", 80, 95)]
    host = [("cudaGraphLaunch", 44, 58), ("aten::copy_", 50, 55)]
    return tr.Trace(device=dev, host=host, window=(0, 100), window_s=1e-4,
                    units=2)


def test_busy_and_breakdown_of_a_trace():
    t = _trace()
    assert t.busy_s() == pytest.approx(70e-6)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["sm90_xmma_fprop", pytest.approx(35e-6)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(15e-6)]
    assert ["python", pytest.approx(5e-6)] in b["idle_gaps"]


def test_per_layer_readers_on_a_made_up_record():
    spec = Spec()
    read = {m["name"]: spec.reader(m).read for m in spec.doc["per_layer"]}
    record = {"trace": _trace(), "step_s": 0.05, "step_flops": 1.0e12,
              "peak_flops": 67e12,
              "kernel_least_s": {"window_gather": 4e-6, "bn_stats": 10e-6},
              "kernel_launches": {"window_gather": 2, "bn_stats": 2},
              "request_ms": np.arange(1.0, 101.0)}
    assert read["train.device_idle_share"](record) == pytest.approx(30.0)
    assert read["serve.device_idle_share"](record) == pytest.approx(30.0)
    assert read["serve.busy_ms_per_request"](record) == pytest.approx(0.035)
    assert read["train.device_ops_per_step"](record) == 3.5
    assert read["train.conv_ms_per_step"](record) == pytest.approx(0.0175)
    assert read["train.pointwise_ms_per_step"](record) == pytest.approx(0.005)
    # least 2 x 2 + 2 x 5 = 14 us of 30 us on the device
    assert read["train.kernels_roofline_share"](record) == \
        pytest.approx(100 * 14 / 30)
    assert read["train.step_mfu"](record) == pytest.approx(100 / 3.35)
    assert read["serve.request_ms_p99"](record) == pytest.approx(99.01)
    # the GOD cell's split of each quantity reads alike
    for name in [n for n in read if n.startswith("train.")]:
        assert read["god." + name[6:]](record) == read[name](record)
    # a reader with nothing to read returns nothing, never 0
    empty = {"trace": tr.Trace(window=(0, 1), units=1)}
    for name in ("train.kernels_roofline_share", "train.conv_ms_per_step",
                 "train.device_idle_share", "serve.busy_ms_per_request",
                 "serve.request_ms_p99"):
        assert read[name](empty) is None
