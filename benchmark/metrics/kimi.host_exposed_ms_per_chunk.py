"""kimi.host_exposed_ms_per_chunk: device idle ms a traced chunk that waits
on the host inside the program's ``llm.chunk`` spans
(``benchcore/chunk_trace.py``); moves ``request_ms_p50``.  Named as
``llm.host_exposed_ms_per_chunk`` is, out of the count of the tracing
PR's readers (names that hold ``exposed_host``) in
``tests/test_cellbench_spans.py``."""

from benchcore.chunk_trace import exposed_host_ms_in


def read(record):
    return exposed_host_ms_in(record, "llm.chunk")
