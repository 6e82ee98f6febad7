"""llm.moe_kernels_roofline_share: the hand-written route and combine
kernels' (``csrc/moe_route.cu``) least time, their bytes at 3.35 TB/s
(``benchcore/counts_llm.py``), over their traced time, in %
(``benchcore/llm_trace.py``); moves ``request_ms_p50``."""

from benchcore.llm_trace import moe_kernels_roofline_share


def read(record):
    return moe_kernels_roofline_share(record)
