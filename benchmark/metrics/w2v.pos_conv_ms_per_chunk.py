"""w2v.pos_conv_ms_per_chunk: device ms a traced chunk of the chunk
graph's operations in scope ``w2v_pos_conv``, the positional conv (its
weight-norm kernel and the grouped conv), its GELU aside
(``benchcore/program_trace.py``); moves ``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "w2v_pos_conv")
