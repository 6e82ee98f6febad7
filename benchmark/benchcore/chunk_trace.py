"""What the program's own spans say of a traced stretch whose unit is a
chunk of the speech embedding (``drivers/embed_closed_loop.py``): the
device's waits on the host inside a span that ``benchcore/
program_trace.py`` does not list (``w2v.chunk``), found among the trace's
host ranges by name.  A program without the span, or whose replays do
not map one for one onto their tables, gives None."""

from __future__ import annotations

from benchcore import program_trace as pt

__all__ = ["exposed_host_ms_in"]


def _union(ranges) -> list:
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def exposed_host_ms_in(record, span: str):
    """Device ms a traced unit that waits on the host (the next operation
    not yet enqueued: ``program_trace.waiting_gaps``) while a ``span``
    range runs on the host."""
    trace = record.get("trace")
    if trace is None or not trace.units:
        return None
    ranges = _union((s, e) for name, s, e in trace.host
                    if name.partition("#")[0] == span)
    if not ranges:
        return None
    found = pt.attribute(trace, pt.tables())
    if found is None:
        return None
    us, j = 0.0, 0
    for gs, ge in pt.waiting_gaps(trace, found.ops):
        while j < len(ranges) and ranges[j][1] <= gs:
            j += 1
        k = j
        while k < len(ranges) and ranges[k][0] < ge:
            us += max(0.0, min(ranges[k][1], ge) - max(ranges[k][0], gs))
            k += 1
    return us / 1e3 / trace.units
