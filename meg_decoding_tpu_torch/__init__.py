"""meg_decoding_tpu_torch — the PyTorch/CUDA port of ``meg_decoding_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and names so a reader finds each counterpart at the same path.  It
imports ``torch``, numpy, scipy and yaml, and nothing of JAX or of the JAX
package.

Covered so far, on one device: the Gwilliams2022 speech workload's serving,
eval and training paths (``cli/evaluate_speech.py``,
``cli/train_speech.py``) and the GOD image workload's data build, training
with every loss kind and evaluation (``cli/train_god.py``,
``cli/evaluate_god.py``).  The four TPU (Pallas) kernels on those paths are
hand-written CUDA C++ kernels for Hopper (``csrc/``), built with ``nvcc``
at first use:

* ``ops/kernels/window_gather.py`` — batched (recording, onset) windows;
* ``ops/kernels/quantile.py`` — exact per-row 25/50/75th percentiles;
* ``ops/kernels/batchnorm.py`` — BatchNorm statistics (``bn_stats``) and
  the BatchNorm backward (``bn_bwd``).

Every entry point takes ``device`` (default ``"cuda"``); without a GPU it
raises unless the caller asks for ``"cpu"`` (``device.py``).
"""

__version__ = "0.1.0"
