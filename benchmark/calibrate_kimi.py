"""Reads, on the card, the numbers that decide ``correct`` in the cell of
the ``kimi_embed_closed_loop`` driver, for the readings its limits are set
from (``limits/kimilinear_embed_2to32k.json``), as ``calibrate_text.py``
does for DeepSeek-V2-Lite's:

* ``sound``: the program as the cell runs it;
* ``control``: the reference in the program's place, every product at the
  traffic mix's ``control`` precision, routed by itself (the f32
  reference it is held to is routed as it routed);
* a fault of ``benchcore/faults_kimi.py`` planted in the program.

    python3 benchmark/calibrate_kimi.py --workload kimilinear_embed_2to32k \\
        --seeds 1,2,3 --what sound,control,route_negated,kda_state_dropped

Each reading embeds the cell's kept documents (one of each of the mix's
``kept_chunks`` chunk counts, drawn from the seed) and compares them with
the reference's.  Prints one JSON line a reading: the cell, the seed,
what ran, each number, the seconds it took.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchcore import port_kimi as port  # noqa: E402
from benchcore.faults_kimi import FAULTS, planted  # noqa: E402
from benchcore.spec import Spec  # noqa: E402


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def kimi_readings(cfg, mix, seed, whats, dev):
    import drivers.kimi_embed_closed_loop as kc
    import drivers.text_embed_closed_loop as tc

    docs = tc.documents(cfg, mix, seed, dev)
    kept = [docs[j] for j in tc.kept_docs(cfg, mix, docs, seed)]
    for what in whats:
        t0 = time.perf_counter()
        if what == "control":
            ctl = kc.reference_outputs(cfg, kept, [None] * len(kept), seed,
                                       dev, mix["control"])
            outs = [E for E, _ in ctl]
            routes = [torch.stack(info["routes"]).cpu() for _, info in ctl]
            del ctl
        else:
            with planted(what) if what in FAULTS else contextlib.nullcontext():
                embedder = port.Embedder(cfg, kc.weights(cfg, seed, dev), dev,
                                         seed)
                outs, routes = [], []
                for ids, ends in kept:
                    outs.append(embedder(ids, ends).cpu())
                    routes.append(embedder.routes(len(ids)))
                del embedder
        _free(dev)
        refs = kc.reference_outputs(cfg, kept, routes, seed, dev)
        _free(dev)
        yield what, tc.compare(outs, refs), time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="sound,control")
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
        for what, numbers, secs in kimi_readings(cfg, mix, seed, whats, dev):
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "what": what, "numbers": numbers,
                              "seconds": secs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
