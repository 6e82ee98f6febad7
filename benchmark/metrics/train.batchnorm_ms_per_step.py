"""train.batchnorm_ms_per_step: device ms a traced step of the replay's
operations in the program's scope "batchnorm"
(``benchcore/program_trace.py``); moves ``train_samples_per_s``."""

from benchcore.program_trace import scope_ms


def read(record):
    return scope_ms(record, "batchnorm")
