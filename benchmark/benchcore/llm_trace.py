"""What a traced stretch of the text embedding says of DeepSeek-V2's MoE
(``drivers/text_embed_closed_loop.py``), for the per-layer readers: the
share of its least time (``benchcore/counts_llm.py``) that the grouped
GEMMs, and the route and combine kernels, reached; the experts' load.  A
stretch without such operations gives None (never 0)."""

from __future__ import annotations

import re

from benchcore import program_trace as pt
from benchcore.counts_llm import (
    experts_gemm_bound_s,
    moe_kernels_bound_s,
    moe_layer_count,
)

__all__ = ["GEMM", "MOE_KERNELS", "experts_gemm_roofline_share",
           "moe_kernels_roofline_share", "expert_load_imbalance"]

# the grouped GEMMs' kernels among the operations of scope moe_experts
GEMM = re.compile(r"gemm|cutlass", re.IGNORECASE)
# the hand-written kernels of csrc/moe_route.cu by their names
MOE_KERNELS = re.compile(r"moe_route_topk_kernel|moe_route_place_kernel|"
                         r"moe_combine_kernel")


def _share(bound_s: float, busy_us: float):
    return 100.0 * bound_s * 1e6 / busy_us if busy_us > 0 else None


def experts_gemm_roofline_share(record):
    """The grouped GEMMs' least time over their traced time, in %: the
    kernels of scope ``moe_experts`` whose names are a GEMM's, found
    through the replays' capture tables (``program_trace.attribute``)."""
    trace, llm = record.get("trace"), record.get("llm")
    if trace is None or not trace.units or llm is None:
        return None
    found = pt.attribute(trace, pt.tables())
    if found is None:
        return None
    # attribute() lists the operations in this order, each with its owner;
    # the replays that did not map one for one count as the mapped ones do
    ops = sorted(trace.device, key=lambda r: (r[1], r[2]))
    us = sum(e - s for (name, s, e), (owner, _, _, _) in zip(ops, found.ops)
             if owner == "moe_experts" and GEMM.search(name)) \
        * found.replays / found.mapped
    if us <= 0:
        return None
    m = llm["model"]
    return _share(trace.units * moe_layer_count(m)
                  * experts_gemm_bound_s(m, llm["chunk_tokens"]), us)


def moe_kernels_roofline_share(record):
    """The route and combine kernels' least time over their traced time,
    in %."""
    trace, llm = record.get("trace"), record.get("llm")
    if trace is None or not trace.units or llm is None:
        return None
    us = sum(e - s for name, s, e in trace.device if MOE_KERNELS.search(name))
    if us <= 0:
        return None
    m = llm["model"]
    return _share(trace.units * moe_layer_count(m)
                  * moe_kernels_bound_s(m, llm["chunk_tokens"]), us)


def expert_load_imbalance(record):
    """The busiest expert's tokens over the mean expert's, a MoE layer,
    averaged over the layers: the program's counter after the window's
    last request."""
    counts = record.get("expert_counts")
    if counts is None:
        return None
    ratios = [max(row) / (sum(row) / len(row)) for row in counts.tolist()
              if sum(row) > 0]
    return sum(ratios) / len(ratios) if ratios else None
