"""Training entry point of the PyTorch/CUDA port (``meg_decoding_tpu_torch``).

The counterpart of the repo-root ``train.py`` (which runs the JAX package):
one dispatcher, selected by ``dataset:`` in the config
(``configs/config.yaml`` / ``configs/config_GOD.yaml``), on ``--device``
(default ``cuda``; ``--device cpu`` on a machine without a GPU).

    python train_torch.py dataset=GOD epochs=10
    python train_torch.py --device cpu dataset=Gwilliams2022 cache_dir=DIR
    python train_torch.py -m dataset=GOD lr=1e-3,3e-4   # a 2-job sweep
"""

import sys

if __name__ == "__main__":
    from meg_decoding_tpu_torch.cli.main import train_main

    train_main(sys.argv[1:])
