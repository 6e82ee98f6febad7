"""train.pointwise_ms_per_step: device ms a traced step of the group
"elementwise" (``benchcore/readers.py``); moves ``train_samples_per_s``."""

from benchcore.readers import group_ms_per_unit


def read(record):
    return group_ms_per_unit(record, "elementwise")
