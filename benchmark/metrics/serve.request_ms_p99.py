"""serve.request_ms_p99: the 99th percentile of the window's request
latencies, host clock (``benchcore/readers.py``): the stalls of a
request's host path that the 95th percentile passes over; moves
``request_ms_p95``."""

from benchcore.readers import request_ms_percentile


def read(record):
    return request_ms_percentile(record, 99)
