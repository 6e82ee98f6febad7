"""god.device_ops_per_step: device operations a traced step
(``benchcore/readers.py``); moves ``god_train_samples_per_s``."""

from benchcore.readers import ops_per_unit


def read(record):
    return ops_per_unit(record)
