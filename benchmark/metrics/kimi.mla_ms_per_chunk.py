"""kimi.mla_ms_per_chunk: device ms a traced chunk of the chunk graphs'
operations in scope ``mla``, the 7 MLA layers without rope (input norm,
projections, the latent cache's write and read, the prefix's expansion,
flash attention, o_proj) (``benchcore/program_trace.py``); moves
``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "mla")
