"""llm.experts_gemm_roofline_share: the routed experts' grouped GEMMs'
least time (each the larger of its operations at the bf16 peak and its
bytes at 3.35 TB/s: every expert's weights read once, its rows in and out;
``benchcore/counts_llm.py``) over their traced time, in %
(``benchcore/llm_trace.py``); moves ``request_ms_p50``."""

from benchcore.llm_trace import experts_gemm_roofline_share


def read(record):
    return experts_gemm_roofline_share(record)
