"""Benchmark of the PyTorch/CUDA port (``meg_decoding_tpu_torch``):
Gwilliams2022 training throughput on one card at the dataset's full scale.

The counterpart of the repo-root ``bench.py`` (which runs the JAX package):
the same rows and keys, each timing the route a user of the port takes
(the fused step as a CUDA graph replay, the whole-epoch form, the eval
pool's graph), MFU against the H100's data-sheet peaks, one JSON line on
stdout (``meg_decoding_tpu_torch/cli/bench.py``).  Runs on the card unless
``--device cpu``.

    python3 bench_torch.py                          # full scale, 9.34 GB resident
    python3 bench_torch.py --scale small --big-batches ''
    python3 bench_torch.py --tiny --device cpu --steps 2 --windows 2
"""

import sys

if __name__ == "__main__":
    from meg_decoding_tpu_torch.cli.bench import main

    sys.exit(main(sys.argv[1:]))
