"""Reads, on the card, the numbers that decide a cell's ``correct`` for
the readings its limits are set from (``limits/<workload>.json``):

* ``sound``: the program as the cell runs it;
* ``control``: the reference in the program's place, its convolutions
  and products at the traffic mix's ``control`` precision;
* a fault of ``benchcore/faults.py`` planted in the program.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --what sound,control,state_unchanged,half_batch,answer_altered

Training cells read the comparison's three steps (no window); the
serving cell reads ``--requests`` requests of its pool one after another,
as its closed loop sends them.  Prints one JSON line a reading: the
cell, the seed, what ran, each number, and the leaf that set it.
"""

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchcore import checks, port  # noqa: E402
from benchcore.data import make_data, sensor_locations  # noqa: E402
from benchcore.faults import FAULTS, planted  # noqa: E402
from benchcore.spec import Spec  # noqa: E402


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _worst(prog: dict, ref: dict) -> dict:
    """The leaf that sets each of ``grad`` and ``change``, and the
    leaves left out of both."""
    out = {}
    for key, names in zip(("grad", "change"), checks.compared_leaves(ref)):
        p, r = prog[key + "_norms"], ref[key + "_norms"]
        med = statistics.median(r[k] for k in names)
        out[key] = max(names, key=lambda k: abs(p[k] - r[k]) / max(r[k], med))
    out["left_out"] = sorted(set(ref["grad_norms"]) - set(checks.compared_leaves(ref)[0]))
    return out


def train_readings(cfg, mix, seed, whats, dev):
    import drivers.train_window as tw

    data = make_data(cfg, seed, dev)
    draws = tw.first_draws(data, seed, mix["batch_size"], cfg["model"]["C"])
    ref = tw.reference_first_steps(cfg, data, draws, seed, dev)
    _free(dev)
    for what in whats:
        if what == "control":
            prog = tw.reference_first_steps(cfg, data, draws, seed, dev,
                                            mix["control"])
        else:
            with planted(what) if what in FAULTS else contextlib.nullcontext():
                trainer = port.Trainer(cfg, mix, data,
                                       tw.weights_of(cfg, seed, dev),
                                       sensor_locations(cfg), dev)
                prog = tw.program_first_steps(trainer, draws)
                del trainer
        _free(dev)
        yield what, checks.train_numbers(prog, ref), _worst(prog, ref)


def serve_readings(cfg, mix, seed, whats, dev, n):
    import drivers.serve_closed_loop as sc

    X, subs = sc.requests(cfg, mix, seed, dev)
    kept = list(range(min(n, len(X))))
    ref = sc.reference_outputs(cfg, kept, X, subs, seed, dev)
    for what in whats:
        if what == "control":
            outs = sc.reference_outputs(cfg, kept, X, subs, seed, dev,
                                        mix["control"])
        else:
            with planted(what) if what in FAULTS else contextlib.nullcontext():
                weights, running = sc.model_tensors(cfg, seed, dev)
                server = port.Server(cfg, mix, weights, running,
                                     sensor_locations(cfg), dev)
                outs = [server(X[j], subs[j]) for j in kept]
                del server
        _free(dev)
        yield what, {"output": max(checks.serve_gap(z, r)
                                   for z, r in zip(outs, ref))}, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="sound,control")
    ap.add_argument("--requests", type=int, default=72)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.cell(args.workload)
    cfg, mix = spec.config(cell), spec.traffic(cell)
    dev = port.device(args.device)
    if dev.type == "cuda":
        port.build_kernels()
    whats = args.what.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        if mix["driver"] == "serve_closed_loop":
            rows = serve_readings(cfg, mix, seed, whats, dev, args.requests)
        else:
            rows = train_readings(cfg, mix, seed, whats, dev)
        for what, numbers, worst in rows:
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "what": what, "numbers": numbers,
                              "worst": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
