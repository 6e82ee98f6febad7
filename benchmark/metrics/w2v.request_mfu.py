"""w2v.request_mfu: the model FLOPs of the untraced window's chunks
(``benchcore/counts_w2v.py``, a full-size forward a chunk) over the
window's summed request time and the card's f32 peak, in %; moves
``request_ms_p50``."""


def read(record):
    if "window_flops" not in record or not record.get("request_s"):
        return None
    return (100.0 * record["window_flops"] / record["request_s"]
            / record["peak_flops"])
