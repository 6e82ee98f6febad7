"""god.conv_ms_per_step: device ms a traced step of the group "convolution"
(``benchcore/readers.py``); moves ``god_train_samples_per_s``."""

from benchcore.readers import group_ms_per_unit


def read(record):
    return group_ms_per_unit(record, "convolution")
