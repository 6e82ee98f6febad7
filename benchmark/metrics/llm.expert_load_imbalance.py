"""llm.expert_load_imbalance: the busiest routed expert's tokens over the
mean expert's, a MoE layer, averaged over the 26 layers, from the
program's (layers, experts) counter of the window's last request
(``benchcore/llm_trace.py``); moves ``request_ms_p50``."""

from benchcore.llm_trace import expert_load_imbalance


def read(record):
    return expert_load_imbalance(record)
