"""What a traced stretch of Kimi-Linear's text embedding says of its KDA
kernel (``drivers/kimi_embed_closed_loop.py``), for the per-layer reader
``kimi.kda_kernel_roofline_share``: the share of the kernel's least time
(``benchcore/counts_kimi.py``) that its traced time reached.  A stretch
without the kernel gives None (never 0)."""

from __future__ import annotations

import re

from benchcore.counts_kimi import kda_bound_s
from reference.kimi_linear import kda_layers

__all__ = ["KDA_KERNELS", "kda_kernel_roofline_share"]

# the kernels of csrc/kda.cu by their names (one call launches both)
KDA_KERNELS = re.compile(r"kda_prep_kernel|kda_state_kernel")


def kda_kernel_roofline_share(record):
    """The KDA kernel's least time over its traced time, in %: every
    traced chunk runs it once a KDA layer over the chunk's full length."""
    trace, llm = record.get("trace"), record.get("llm")
    if trace is None or not trace.units or llm is None:
        return None
    us = sum(e - s for name, s, e in trace.device if KDA_KERNELS.search(name))
    if us <= 0:
        return None
    m = llm["model"]
    bound_us = (trace.units * len(kda_layers(m))
                * kda_bound_s(m, llm["chunk_tokens"]) * 1e6)
    return 100.0 * bound_us / us
