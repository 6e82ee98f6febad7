"""The benchmark of ``meg_decoding_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It runs one cell of ``BENCHMARK.json``
(its configuration, traffic mix, limits and per-layer readers are found
by name under ``benchmark/``), then prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (traced
runs) and, last, ``checks``: each number compared beside its limit, also
the last lines of standard error.

It exits non-zero with no result line when no card is present, when the
cell asks for more cards than there are, and when JAX or the JAX package
was loaded into the process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for _p in (ROOT, BENCH_DIR):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# modules that must never be loaded: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "meg_decoding_tpu")


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` among ``FORBIDDEN``, each name
    compared whole (``meg_decoding_tpu_torch`` is not
    ``meg_decoding_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str = "cuda", config_overrides=None) -> int:
    """Runs the cell; ``device`` and ``config_overrides`` (a dict of
    ``section.key`` → value) are for the benchmark's own tests on the
    CPU."""
    args = parse(argv)
    from benchcore.spec import Spec

    spec = Spec(ROOT, BENCH_DIR)
    cell = spec.cell(args.workload)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"the cell asks for {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
    from benchcore.cell import run_cell

    result, lines = run_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace), device, T0, config_overrides)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
