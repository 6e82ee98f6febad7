"""llm.shared_ms_per_chunk: device ms a traced chunk of the chunk graphs'
operations in scope ``moe_shared``, the shared experts and the first
layer's dense MLP (``benchcore/program_trace.py``); moves
``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "moe_shared")
