"""god.device_idle_share: the traced window's share with no device
operation, in % (``benchcore/readers.py``); moves
``god_train_samples_per_s``."""

from benchcore.readers import idle_share


def read(record):
    return idle_share(record)
