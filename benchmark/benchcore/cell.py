"""One run of one cell: its files found by name, its driver run, its
metrics read, its result line made.

A driver (``drivers/<name>.py``) has ``run(ctx) → record``: a dict with
``e2e`` (the end-to-end values it measured, by metric name), optionally
``rate`` (``{"value", "unit"}``: the cell's end-to-end metric of that
unit that ``e2e`` does not name, such as a training rate), ``numbers``
(the compared numbers, by limit name), ``attempted``, ``failed``,
``memory_peak_bytes`` and, for per-layer readers, whatever they read
(``trace`` in a traced run).  A per-layer reader (``metrics/<name>.py``)
has ``read(record) → value or None``; a None leaves the metric out.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass, field

import torch

from benchcore import checks
from benchcore.trace import breakdown

__all__ = ["Context", "run_cell", "device_info"]


@dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic mix
    (as their files hold them), the run's flags, the device, and ``t0``
    (the process's start on ``time.perf_counter``'s clock, where
    ``setup_s`` begins)."""
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float
    marks: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Ends a phase of set-up (the seconds since ``t0``, printed to
        standard error)."""
        self.marks.append((phase, time.perf_counter() - self.t0))

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def device_info(device: str, record: dict, trace) -> dict:
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(record["memory_peak_bytes"])}
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
    if dev.type == "cuda":
        info["power_limit"] = _power_limit()
    return info


def _end_to_end(record: dict, metric: dict) -> float:
    """The metric's value: by its name in ``e2e``, else the record's
    ``rate`` where the units agree."""
    if metric["name"] in record["e2e"]:
        return record["e2e"][metric["name"]]
    rate = record.get("rate")
    if rate is None or rate["unit"] != metric["unit"]:
        raise KeyError(f"the driver measured no {metric['name']} "
                       f"({metric['unit']})")
    return rate["value"]


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, config_overrides: dict | None = None
             ) -> tuple:
    """``(result, check_lines)``: the result line's object and the lines
    that name each compared number beside its limit.  ``config_overrides``
    (tests: small shapes on the CPU) maps ``section.key`` of the
    configuration, or ``traffic.key`` of the mix, to a value."""
    cell = spec.cell(name)
    config, mix = spec.config(cell), spec.traffic(cell)
    for key, value in (config_overrides or {}).items():
        section, _, leaf = key.rpartition(".")
        target = mix if section == "traffic" else config
        (target[section] if section not in ("", "traffic") else target)[leaf] = value
    ctx = Context(cell, config, mix, int(seed), float(seconds), bool(trace),
                  device, t0)
    record = spec.driver(mix).run(ctx)
    correct, rows = checks.judge(record["numbers"], spec.limits(cell))
    if trace:
        metrics = {}
        for m in spec.per_layer(cell):
            value = spec.reader(m).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": _end_to_end(record, m),
                               "unit": m["unit"]}
                   for m in spec.end_to_end(cell)}
    tr = record.get("trace") if trace else None
    result = {"correct": bool(correct), "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics,
              "device": device_info(device, record, tr)}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checks"] = rows
    lines = ["set-up: " + ", ".join(f"{p} at {t:.2f} s" for p, t in ctx.marks)]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in rows.items()]
    return result, lines
