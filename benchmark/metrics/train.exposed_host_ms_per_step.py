"""train.exposed_host_ms_per_step: device idle ms a traced step while a program
span runs on the host
(``benchcore/program_trace.py``); moves ``train_samples_per_s``."""

from benchcore.program_trace import exposed_host_ms


def read(record):
    return exposed_host_ms(record)
