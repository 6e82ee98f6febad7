"""w2v.attention_ms_per_chunk: device ms a traced chunk of the chunk
graph's operations in scope ``attention``, the layers' attention (q, k,
v and out projections, scores, mask bias, softmax)
(``benchcore/program_trace.py``); moves ``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "attention")
