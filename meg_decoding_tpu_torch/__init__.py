"""meg_decoding_tpu_torch — the PyTorch/CUDA port of ``meg_decoding_tpu``.

The JAX package beside it is the reference; this package mirrors its module
paths and names so a reader finds each counterpart at the same path.  It
imports ``torch``, numpy, scipy and yaml, and nothing of JAX or of the JAX
package.

Covered so far: the Gwilliams2022 serving and eval path — gather →
collate → eval-mode ``BrainEncoder`` → CLIP logits and retrieval metrics.
The two TPU (Pallas) kernels on that path are hand-written CUDA C++ kernels
for Hopper (``csrc/``), built with ``nvcc`` at first use:

* ``ops/kernels/window_gather.py`` — batched (recording, onset) windows;
* ``ops/kernels/quantile.py`` — exact per-row 25/50/75th percentiles.

Every entry point takes ``device`` (default ``"cuda"``); without a GPU it
raises unless the caller asks for ``"cpu"`` (``device.py``).
"""

__version__ = "0.1.0"
