"""Where the time of one training step goes on the card.

``--workload speech``: the synthetic 27-subject Gwilliams cache that
``chip_smoke.py`` also runs on (``data/synthetic.py:full_width_speech``),
the full-width model of ``configs/config.yaml`` (or of a speed preset,
``--config-name throughput`` / ``throughput_exact``: bf16, B = 256, the
cached collate statistics) with random weights, and the fused train step
(session draw, window gather, collate, encoder in training mode, CLIP
loss, gradients, Adam, BN running statistics); the sweep of the cached
statistics runs before the timed steps.
``--workload god``: the full-width GOD set-up of ``chip_smoke.py``
(``full_width_god``: ``configs/config_GOD.yaml``, T = 24; any model of
the zoo with ``model=…``), its train split
built on the card, and the per-step form ``fit`` runs (a gather from the
packed set, then ``make_train_step``'s step).  After 3 warm-up steps it
times 10 steps with the host clock around work that ends in
``torch.cuda.synchronize()``, then traces as many more with
``torch.profiler`` and sums the device time of every kernel, by name and
by group, and the share of the traced window in which the card ran no
kernel.  Prints one JSON object per configuration; also writes them under
``--out``.

Needs a GPU; there is no CPU mode.

Run from the repository root:
``python -m meg_decoding_tpu_torch.cli.profile_train_step [--out DIR]
[--workload speech|god] [--config-name NAME] [--dtypes float32,bfloat16]
[key=value …]``
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from meg_decoding_tpu_torch.cli.evaluate_speech import (
    SpeechPool,
    collate_config,
)
from meg_decoding_tpu_torch.cli.train_god import _loss_config as god_loss_config
from meg_decoding_tpu_torch.cli.train_speech import loss_config
from meg_decoding_tpu_torch.data.god import build_god_dataset
from meg_decoding_tpu_torch.data.layout import ch_locations_2d
from meg_decoding_tpu_torch.data.roi import roi
from meg_decoding_tpu_torch.data.synthetic import full_width_god, full_width_speech
from meg_decoding_tpu_torch.device import resolve_device
from meg_decoding_tpu_torch.models.factory import get_model
from meg_decoding_tpu_torch.train.scan_loop import make_fused_speech_step
from meg_decoding_tpu_torch.train.schedules import make_optimizer
from meg_decoding_tpu_torch.train.state import create_train_state
from meg_decoding_tpu_torch.train.steps import make_train_step

__all__ = ["kernel_group", "busy_us", "main"]

WARMUP, STEPS, SEED = 3, 10, 0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# kernel name → group, first match wins
_GROUPS = (
    ("bn_statistics", r"bn_stats_kernel|bn_bwd_\w*kernel"),
    ("window_gather", r"window_gather"),
    ("robust_quantiles", r"quantile"),
    ("convolution", r"conv|cudnn|xmma|implicit|wgrad|dgrad|fprop"),
    ("matmul", r"gemm|cutlass|ampere|sm90|magma"),
    ("reduction", r"reduce|norm"),
    ("elementwise", r"elementwise|vectorized|unrolled|Memset|fill"),
    ("copy", r"Memcpy|copy|cat|index"),
)


def kernel_group(name: str) -> str:
    for group, pattern in _GROUPS:
        if re.search(pattern, name, flags=re.IGNORECASE):
            return group
    return "other"


def busy_us(intervals) -> float:
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


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def speech_step(work: str, seed: int, overrides, config_name: str = "config"):
    """(cfg, one): the fused speech step on the full-width cache; ``one(i)``
    runs step i and returns its metrics."""
    cfg, ds, tr_idx = full_width_speech(work, seed, overrides,
                                        config_name=config_name)
    model = get_model(cfg, ch_locations_2d(cfg), device="cuda", seed=seed)
    opt = make_optimizer(cfg, int(cfg.updates))
    state = create_train_state(model, opt, float(cfg.init_temperature), seed)
    fused = make_fused_speech_step(
        model, opt, loss_config(cfg), collate_config(cfg), ds,
        cache_collate_stats=bool(cfg.get("cache_collate_stats", False)))
    pool = SpeechPool(ds, tr_idx, seed=seed)
    rng = np.random.RandomState(seed)
    B = int(cfg.batch_size)

    def one(i):
        idx = pool.segment_ids(rng.randint(0, len(pool), B))
        return fused(state, idx, generator=torch.Generator().manual_seed(i))[1]

    return cfg, one


def god_step(work: str, seed: int, overrides, config_name: str = "config_GOD"):
    """(cfg, one): the per-step GOD step over the full-width train split."""
    cfg = full_width_god(work, seed, overrides, config_name=config_name)
    ds = build_god_dataset(cfg, "train", device="cuda")
    cfg.num_subjects = ds.num_subjects
    roi_channels = roi(cfg)
    model = get_model(cfg, ch_locations_2d(cfg, roi_channels), device="cuda",
                      seed=seed, num_channels=len(roi_channels))
    opt = make_optimizer(cfg, int(cfg.updates))
    state = create_train_state(model, opt, float(cfg.init_temperature), seed)
    step = make_train_step(model, opt, god_loss_config(cfg), collate_config(cfg))
    rng = np.random.RandomState(seed)
    B = int(cfg.batch_size)

    def one(i):
        return step(state, *ds.gather(rng.randint(0, len(ds), B))[:3])[1]

    return cfg, one


def profile_config(cfg, one, warmup: int, steps: int) -> dict:
    B = int(cfg.batch_size)

    for i in range(warmup):
        one(i)
    torch.cuda.synchronize()
    step_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        m = one(warmup + i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if float(m["skipped"]) != 0.0:
            raise FloatingPointError(f"step {i} was skipped")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            one(warmup + steps + i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    by_group: dict[str, float] = {}
    for name, (_, us) in by_name.items():
        g = kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + us
    device_us = sum(us for _, us in by_name.values())
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {
        "compute_dtype": str(cfg.get("compute_dtype", "float32")),
        "batch_size": B, "steps": steps,
        "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
        "traced_window_ms": window_us / 1e3,
        "device_ops_per_step": len(kernels) / steps,  # kernels, copies, memsets
        "device_ms_per_step": device_us / 1e3 / steps,
        "busy_ms_per_step": busy / 1e3 / steps,
        "idle_share_of_kernel_span": 1.0 - busy / span,
        "idle_share_of_window": 1.0 - busy / window_us,
        "groups_ms_per_step": {g: us / 1e3 / steps for g, us in
                               sorted(by_group.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "group": kernel_group(n),
                         "calls_per_step": c / steps,
                         "ms_per_step": us / 1e3 / steps}
                        for n, (c, us) in top],
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", choices=("speech", "god"), default="speech")
    ap.add_argument("--config-name", default=None,
                    help="configs/<name>.yaml (default: config for speech, "
                         "config_GOD for god)")
    ap.add_argument("--dtypes", default=None,
                    help="compute dtypes to profile, comma-separated "
                         "(default: the config's own)")
    ap.add_argument("--out", default=None, help="directory for the JSON result")
    ap.add_argument("overrides", nargs="*", help="key=value config overrides")
    args = ap.parse_args(argv)
    resolve_device("cuda")  # raises without a GPU; TF32 off
    smi = _nvidia_smi()
    print(smi, flush=True)
    work = os.path.join(_ROOT, "runs_out", f"profile_train_step_{os.getpid()}")
    make = {"speech": speech_step, "god": god_step}[args.workload]
    results = []
    try:
        for dtype in (args.dtypes.split(",") if args.dtypes else [None]):
            torch.cuda.reset_peak_memory_stats()
            names = {} if args.config_name is None else \
                {"config_name": args.config_name}
            dtype_override = [f"compute_dtype={dtype}"] if dtype else []
            cfg, one = make(work, SEED, [*dtype_override, *args.overrides],
                            **names)
            res = {"device": smi, "torch": torch.__version__,
                   "workload": args.workload,
                   **profile_config(cfg, one, WARMUP, STEPS)}
            print(json.dumps(res), flush=True)
            results.append(res)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_train_step.json"), "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
