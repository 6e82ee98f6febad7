"""kimi.request_mfu: the model FLOPs of the untraced window's documents
(``benchcore/counts_kimi.py``: their real tokens through every layer, the
routed experts' rows of the experts held here only, and the MLA layers'
causal attention over them) over the window's summed request time and the
card's bf16 peak, in %; moves ``request_ms_p50``."""


def read(record):
    if "window_flops" not in record or not record.get("request_s"):
        return None
    return (100.0 * record["window_flops"] / record["request_s"]
            / record["peak_flops"])
