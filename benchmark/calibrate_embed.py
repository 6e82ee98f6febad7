"""Reads, on the card, the numbers that decide ``correct`` in the cells
of the ``embed_closed_loop`` driver, for the readings their limits are
set from (``limits/<workload>.json``), as ``calibrate.py`` does for the
training and serving cells:

* ``sound``: the program as the cell runs it;
* ``control``: the reference in the program's place, its convolutions
  and products at the traffic mix's ``control`` precision;
* a fault of ``benchcore/faults_w2v.py`` planted in the program.

    python3 benchmark/calibrate_embed.py --workload w2v_embed_30to120s \\
        --seeds 1,2,3 --what sound,control,mask_dropped,stitch_shifted

Each reading embeds the cell's kept files (one of each of the mix's
``kept_chunks`` chunk counts, drawn from the seed) and compares them with
the reference's.  Prints one JSON line a reading: the cell, the seed,
what ran, each number.
"""

import argparse
import contextlib
import gc
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from benchcore import port_features as port  # noqa: E402
from benchcore.faults_w2v import FAULTS, planted  # noqa: E402
from benchcore.spec import Spec  # noqa: E402


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def embed_readings(cfg, mix, seed, whats, dev):
    import drivers.embed_closed_loop as ec

    files = ec.audio_pool(cfg, mix, seed, dev)
    kept = ec.kept_files(cfg, mix, files, seed)
    ref = ec.reference_outputs(cfg, kept, files, seed, dev)
    _free(dev)
    for what in whats:
        if what == "control":
            outs = ec.reference_outputs(cfg, kept, files, seed, dev,
                                        mix["control"])
        else:
            with planted(what) if what in FAULTS else contextlib.nullcontext():
                embedder = port.Embedder(cfg, ec.model_weights(cfg, seed, dev),
                                         dev)
                outs = [embedder(files[j]).cpu() for j in kept]
                del embedder
        _free(dev)
        yield what, ec.compare(outs, ref)


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
        for what, numbers in embed_readings(cfg, mix, seed, whats, dev):
            print(json.dumps({"cell": args.workload, "seed": seed,
                              "what": what, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
