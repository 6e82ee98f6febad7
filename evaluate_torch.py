"""Evaluation entry point of the PyTorch/CUDA port (``meg_decoding_tpu_torch``).

The counterpart of the repo-root ``evaluate.py`` (which runs the JAX
package): the GOD or speech evaluator, selected by ``dataset:``, on
``--device`` (default ``cuda``).

    python evaluate_torch.py --config-name config_GOD save_root=runs_out
    python evaluate_torch.py --device cpu dataset=Gwilliams2022 save_root=runs_out
"""

import sys

if __name__ == "__main__":
    from meg_decoding_tpu_torch.cli.main import evaluate_main

    evaluate_main(sys.argv[1:])
