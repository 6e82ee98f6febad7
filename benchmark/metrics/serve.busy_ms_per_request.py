"""serve.busy_ms_per_request: device busy ms a traced request
(``benchcore/readers.py``); moves ``request_ms_p50``."""

from benchcore.readers import busy_ms_per_unit


def read(record):
    return busy_ms_per_unit(record)
