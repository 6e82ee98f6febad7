"""The arithmetic of the per-layer readers (``metrics/<name>.py``): each
reader is this module's function applied to its own record, so that a
quantity split by the end-to-end metric it moves reads alike."""

from __future__ import annotations

import numpy as np

from benchcore.trace import hand_kernel, kernel_group

__all__ = ["step_mfu", "ops_per_unit", "group_ms_per_unit",
           "kernels_roofline_share", "idle_share", "busy_ms_per_unit",
           "request_ms_percentile"]


def step_mfu(record):
    """The step's model FLOPs over the untraced window's step time and the
    card's peak for the cell's compute dtype, in %."""
    if "step_s" not in record:
        return None
    return 100.0 * record["step_flops"] / record["step_s"] / record["peak_flops"]


def ops_per_unit(record):
    """Device operations (kernels, copies, memsets) a traced step."""
    trace = record.get("trace")
    if trace is None or not trace.device:
        return None
    return len(trace.device) / trace.units


def group_ms_per_unit(record, group: str):
    """Device ms a traced step of the kernels of ``group``
    (``benchcore/trace.py:GROUPS``)."""
    trace = record.get("trace")
    if trace is None:
        return None
    us = sum(e - s for name, s, e in trace.device
             if kernel_group(name) == group)
    return us / 1e3 / trace.units if us > 0 else None


def kernels_roofline_share(record):
    """The hand-written kernels' least time over their device time in the
    traced steps, in %.  A launch's least time is the bytes its shapes
    need at the card's memory rate (``benchcore/counts.py``); the
    launches are those the trace shows, each at its kernel's mean least
    time over the launches the shapes expect."""
    trace, least = record.get("trace"), record.get("kernel_least_s")
    if trace is None or not least:
        return None
    seen, device_s = {}, {}
    for name, s, e in trace.device:
        kind = hand_kernel(name)
        if kind is not None:
            seen[kind] = seen.get(kind, 0) + 1
            device_s[kind] = device_s.get(kind, 0.0) + (e - s) / 1e6
    if not device_s:
        return None
    launches = record["kernel_launches"]
    bound = sum(seen[k] * least[k] / launches[k] for k in seen if k in least)
    return 100.0 * bound / sum(device_s.values())


def idle_share(record):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    trace = record.get("trace")
    if trace is None or not trace.device:
        return None
    lo, hi = trace.window
    return 100.0 * (1.0 - trace.busy_s() * 1e6 / (hi - lo))


def busy_ms_per_unit(record):
    """Device busy ms (the union of its operations) a traced request or
    step."""
    trace = record.get("trace")
    if trace is None or not trace.device:
        return None
    return trace.busy_s() * 1e3 / trace.units


def request_ms_percentile(record, q: float):
    """The ``q``-th percentile of every request's host-clock latency in
    the untraced window, in ms."""
    ms = record.get("request_ms")
    if ms is None or len(ms) == 0:
        return None
    return float(np.percentile(ms, q))
