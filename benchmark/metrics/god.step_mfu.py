"""god.step_mfu: the whole step's model FLOPs over its time and the card's
peak, in % (``benchcore/readers.py``); moves
``god_train_samples_per_s``."""

from benchcore.readers import step_mfu


def read(record):
    return step_mfu(record)
