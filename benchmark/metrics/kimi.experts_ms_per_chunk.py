"""kimi.experts_ms_per_chunk: device ms a traced chunk of the chunk graphs'
operations in scope ``moe_experts``, the 128 routed experts held (the two
grouped GEMMs over their rows, the SwiGLU between them, the combine)
(``benchcore/program_trace.py``); moves ``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "moe_experts")
