"""serve.exposed_host_ms_per_request: device idle ms a traced request
while a program span runs on the host (``benchcore/program_trace.py``);
moves ``request_ms_p50``."""

from benchcore.program_trace import exposed_host_ms


def read(record):
    return exposed_host_ms(record)
