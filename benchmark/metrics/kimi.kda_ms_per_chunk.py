"""kimi.kda_ms_per_chunk: device ms a traced chunk of the chunk graphs'
operations in scope ``kda``, the 20 KDA layers (input norm, the q, k, v
projections, the short convolution, the gates, the KDA kernel, the gated
norm, o_proj) (``benchcore/program_trace.py``); moves
``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "kda")
