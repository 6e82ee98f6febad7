"""What a traced stretch of a run is reduced to: device operations by
name and group, the busy union, the idle gaps and what the host was doing
in each.  Frozen copies of ``meg_decoding_tpu_torch/cli/
profile_train_step.py``'s kernel-group table and busy-union arithmetic.

A traced stretch is a ``torch.profiler`` capture (CPU and CUDA) of
``n`` steps or requests after an untraced stretch of the same run, its
host-clock window marked by a ``record_function`` span."""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

__all__ = ["GROUPS", "HAND_KERNELS", "kernel_group", "hand_kernel", "busy",
           "idle_gaps", "Trace", "capture", "breakdown"]

# kernel name → group, first match wins (profile_train_step.py:_GROUPS)
GROUPS = (
    ("bn_statistics", r"bn_stats_\w*kernel|bn_bwd_\w*kernel"),
    ("window_gather", r"window_gather"),
    ("robust_quantiles", r"quantile"),
    ("convolution", r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop"),
    ("matmul", r"gemm|cutlass|ampere|sm90|magma"),
    ("reduction", r"reduce|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Memset|fill"),
    ("copy", r"Memcpy|copy|cat|index"),
)

# the port's hand-written kernels by the names their sources give them
# (csrc/*.cu), each under the name its byte count goes by
HAND_KERNELS = (
    ("window_gather", r"window_gather"),
    ("robust_quantiles", r"robust_quantiles|quantile_long"),
    ("bn_stats", r"bn_stats\w*kernel"),
    ("bn_bwd", r"bn_bwd\w*kernel"),
)

WINDOW_SPAN = "bench.traced_window"


def kernel_group(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, flags=re.IGNORECASE):
            return group
    return "other"


def hand_kernel(name: str) -> str | None:
    for kind, pattern in HAND_KERNELS:
        if re.search(pattern, name):
            return kind
    return None


def busy(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals, start: float, stop: float) -> list:
    """The (start, end) stretches of [start, stop] that no interval covers,
    longest first."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, stop)))
        cursor = max(cursor, e)
        if cursor >= stop:
            break
    if cursor < stop:
        gaps.append((cursor, stop))
    return sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


@dataclass
class Trace:
    """Device operations and host operations of a traced stretch, each
    ``(name, start_us, end_us)`` on the profiler's clock; ``window`` the
    stretch's span on that clock; ``window_s`` its host-clock length;
    ``units`` the steps or requests it held."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    window_s: float = 0.0
    units: int = 0

    def busy_s(self) -> float:
        lo, hi = self.window
        return busy((max(s, lo), min(e, hi)) for _, s, e in self.device
                    if e > lo and s < hi) / 1e6


def capture(run, units: int, sync) -> Trace:
    """``run()`` (``units`` steps or requests, ending in ``sync()``) under
    ``torch.profiler``; returns its ``Trace``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_SPAN):
            run()
            sync()
        window_s = time.perf_counter() - t0
    out = Trace(window_s=window_s, units=units)
    for e in prof.events():
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name == WINDOW_SPAN:
            # the span also shows on the device's timeline as an
            # annotation, which is no device operation
            if e.device_type != DeviceType.CUDA:
                out.window = row[1:]
        elif e.device_type == DeviceType.CUDA:
            out.device.append(row)
        else:
            out.host.append(row)
    return out


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each labelled by the innermost host operation running at its
    middle ("python" where none ran): seconds, as measured."""
    by_name: dict = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    gaps = idle_gaps([(s, e) for _, s, e in trace.device], lo, hi)[:top]
    labelled = []
    for s, e in gaps:
        mid = (s + e) / 2
        running = [(hs, name) for name, hs, he in trace.host
                   if hs <= mid <= he]
        label = max(running)[1] if running else "python"
        labelled.append([label, (e - s) / 1e6])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": labelled}
