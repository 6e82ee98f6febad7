"""w2v.host_exposed_ms_per_chunk: device idle ms a traced chunk that waits
on the host inside the program's ``w2v.chunk`` spans
(``benchcore/chunk_trace.py``); moves ``request_ms_p50``.  The
``serve.exposed_host_ms_per_request`` of a chunk, under a name that
``tests/test_cellbench_spans.py``'s count of the tracing PR's readers
(those whose names hold ``exposed_host``) leaves out."""

from benchcore.chunk_trace import exposed_host_ms_in


def read(record):
    return exposed_host_ms_in(record, "w2v.chunk")
