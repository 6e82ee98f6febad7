"""serve.device_idle_share: the traced window's share with no device
operation, in % (``benchcore/readers.py``); moves ``request_ms_p50``."""

from benchcore.readers import idle_share


def read(record):
    return idle_share(record)
