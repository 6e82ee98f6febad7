"""god.optimizer_ops_per_step: graph nodes a traced step in the program's
scope "adam", from its capture table's counter
(``benchcore/program_trace.py``); moves ``god_train_samples_per_s``."""

from benchcore.program_trace import scope_ops


def read(record):
    return scope_ops(record, "adam")
