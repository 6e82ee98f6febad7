"""kimi.kda_kernel_roofline_share: the KDA kernel's (``csrc/kda.cu``) least
time, the larger of the chunk-64 form's operations at 989 TFLOP/s and its
bytes (q, k, v, g, β, o, the state in and out) at 3.35 TB/s
(``benchcore/counts_kimi.py``), over its traced time, in %
(``benchcore/kimi_trace.py``); moves ``request_ms_p50``."""

from benchcore.kimi_trace import kda_kernel_roofline_share


def read(record):
    return kda_kernel_roofline_share(record)
