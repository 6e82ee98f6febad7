"""w2v.ffn_ms_per_chunk: device ms a traced chunk of the chunk graph's
operations in scope ``ffn``, the layers' feed-forward blocks, their
GELUs aside (``benchcore/program_trace.py``); moves
``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "ffn")
