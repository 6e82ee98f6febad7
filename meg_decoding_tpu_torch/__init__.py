"""meg_decoding_tpu_torch — the PyTorch/CUDA port of ``meg_decoding_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and names so a reader finds each counterpart at the same path.  It
imports ``torch``, numpy, scipy and yaml, and nothing of JAX or of the JAX
package.

Covered so far, on one device: the Gwilliams2022 and Brennan2018 speech
workloads' serving, eval and training paths (``cli/evaluate_speech.py``,
``cli/train_speech.py``), the GOD image workload's data build, training
with every loss kind and evaluation with its error analysis
(``cli/train_god.py``, ``cli/evaluate_god.py``, ``cli/eval_analysis.py``),
the stimulus encoders (``features/``: wav2vec2-large-xlsr-53 and CLIP
ViT-B/32 as the port's own modules), the Gwilliams cache builder
(``cli/build_gwilliams_cache.py``) and the dispatching entry points
(``cli/main.py``).  The four TPU (Pallas) kernels on those paths are
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
