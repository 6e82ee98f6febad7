"""kimi.route_ms_per_chunk: device ms a traced chunk of the chunk graphs'
operations in scope ``moe_route``, the sigmoid routing over 256 experts
(f32 router logits, the route kernels with the selection bias and the
held range, the gather into expert order) (``benchcore/program_trace.py``);
moves ``request_ms_p50``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "moe_route")
