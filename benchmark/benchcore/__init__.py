"""The benchmark's own code: the frozen yardstick (data makers, FLOP and
byte counts, the trace arithmetic, the comparisons) and the adapters to
the program under test (``port.py``, the only module here that imports
``meg_decoding_tpu_torch``)."""
