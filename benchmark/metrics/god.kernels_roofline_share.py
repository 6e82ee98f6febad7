"""god.kernels_roofline_share: the hand-written kernels' least time over
their device time, in % (``benchcore/readers.py``); moves
``god_train_samples_per_s``."""

from benchcore.readers import kernels_roofline_share


def read(record):
    return kernels_roofline_share(record)
