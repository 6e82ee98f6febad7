"""The serving forward: collate chain + eval-mode encoder.  Re-exports
``make_serving_forward`` from ``serving/export.py`` (the port of
``meg_decoding_tpu/serving/export.py``), which also writes and loads the
``torch.export`` artifact of the same forward.
"""

from __future__ import annotations

from meg_decoding_tpu_torch.serving.export import make_serving_forward

__all__ = ["make_serving_forward"]
