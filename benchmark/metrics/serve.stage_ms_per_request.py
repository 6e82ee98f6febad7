"""serve.stage_ms_per_request: host ms a traced request of the program's
``graph.stage_pinned`` spans, the copy of the request into its pinned
buffer, less their child spans (``benchcore/program_trace.py``); moves
``request_ms_p95``."""

from benchcore.program_trace import self_ms


def read(record):
    return self_ms(record, "graph.stage_pinned")
