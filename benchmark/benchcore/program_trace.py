"""What the program's own tracing adds to a traced stretch, for the
per-layer readers: its spans (``meg_decoding_tpu_torch/utils/
profiling.py:span``), found among the trace's host ranges by name, and its
capture tables, read from the program's module in ``sys.modules``.  This
module imports nothing of the program (``port.py`` does).  A program
without spans or tables, such as an older commit, gives nothing: each
reading is then None.

A span's host range is named ``<span>#<key>=<value>``: ``graph.replay``
carries ``graph=<id>``, the id of its program's ``CaptureTable``.

**Attribution.**  A replay's device operations run on one stream, in the
order of the graph's kernel, memcpy and memset nodes, which its table
lists with the scope that owns each.  The stretch's device operations,
sorted by start, interleave the replays' blocks with the operations the
host enqueued outside any graph (a launch, memcpy or memset call of the
CUDA runtime or driver in the host ranges).  The block of replay k starts
after every such operation enqueued before its ``graph.replay`` span and
after the blocks of the replays before it, give or take the few
operations of records the profiler lost or split (on an H100, one record
of the 17,304 of an exact-cell stretch, now and then).  A block maps one
for one or not at all: as many operations as its table's nodes, of the
table's kinds in the table's order, none starting before its launch, the
same kernels as most mapped blocks of its table.  A replay whose block
does not map is left out of the scope readings, which average over the
mapped replays; with none mapped, or the stretch not adding up, every
reading is None.  The operations outside the graphs are the launch
calls' in the calls' order, so each device operation has the host call
that enqueued it: its launch call, or its replay's ``graph.replay`` span.

**Exposed host time.**  An idle stretch of the device waits on the host
when the operation after it had not been enqueued when the stretch began
(the call that enqueued it ended later), or when none follows.  The gaps
between the nodes of a graph already launched are the device's own, not
the host's.  The exposed host time is the waiting stretches' part inside
the program's spans; the rest of the waiting is the benchmark's client.
"""

from __future__ import annotations

import bisect
import math
import re
import sys
from collections import Counter
from dataclasses import dataclass

from benchcore.trace import idle_gaps

__all__ = ["PROFILING", "SPANS", "HOST", "UNMAPPED", "Attribution", "parse",
           "spans", "tables", "segments", "idle_by_span", "waiting_gaps",
           "exposed_host_ms", "self_ms", "attribute", "scope_ms",
           "scope_ops"]

PROFILING = "meg_decoding_tpu_torch.utils.profiling"
SPANS = frozenset({"train.step", "train.prepare", "data.gather",
                   "data.upload_idx", "graph.copy_in", "graph.wait_staged",
                   "graph.stage_pinned", "graph.replay", "graph.copy_out",
                   "serve.request"})
# host calls that enqueue one device operation (not cudaGraphLaunch)
LAUNCH = re.compile(r"^cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")


def parse(name: str):
    """``(span, ids)`` of a program span's host range, else None."""
    base, _, rest = name.partition("#")
    if base not in SPANS:
        return None
    return base, dict(kv.split("=", 1) for kv in rest.split(",") if "=" in kv)


def spans(trace) -> list:
    """``(span, ids, start_us, end_us)`` of the program's spans, by start."""
    out = []
    for name, s, e in trace.host:
        p = parse(name)
        if p is not None:
            out.append((p[0], p[1], s, e))
    return sorted(out, key=lambda r: (r[2], -r[3]))


def tables():
    """The program's capture tables by id, or None where the program
    keeps none."""
    mod = sys.modules.get(PROFILING)
    found = getattr(mod, "tables", None)
    if not found:
        return None
    return {t.id: t for t in found.values()}


def _units(record):
    trace = record.get("trace")
    if trace is None or not trace.units:
        return None, None
    return trace, trace.units


def segments(trace) -> list:
    """``(start_us, end_us, span)``: the stretches of the traced window in
    which a program span runs on the host, each under the innermost one
    (disjoint, in order).  A span's self time is the length of its
    stretches."""
    out, stack = [], []  # stack: [span, end, where its next stretch starts]

    def close(t):
        while stack and stack[-1][1] <= t:
            kind, end, cursor = stack.pop()
            if end > cursor:
                out.append((cursor, end, kind))
            if stack:
                stack[-1][2] = max(stack[-1][2], end)

    for kind, _, s, e in spans(trace):
        close(s)
        if stack:
            top = stack[-1]
            if s > top[2]:
                out.append((top[2], s, top[0]))
            top[2] = max(top[2], s)
        stack.append([kind, e, s])
    close(float("inf"))
    return sorted(out)


def idle_by_span(trace, gaps=None) -> dict:
    """Idle time (us) of the device in the traced window, by the innermost
    program span running on the host at each instant (``"outside"``:
    none, the benchmark's client): of ``gaps`` (``[(start, end)]``, in
    order), every idle stretch by default."""
    if gaps is None:
        lo, hi = trace.window
        gaps = sorted(idle_gaps([(s, e) for _, s, e in trace.device], lo, hi))
    segs = segments(trace)
    out = {"outside": sum(e - s for s, e in gaps)}
    j = 0
    for gs, ge in gaps:
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < ge:
            a, b, kind = segs[k]
            d = min(b, ge) - max(a, gs)
            if d > 0:
                out[kind] = out.get(kind, 0.0) + d
                out["outside"] -= d
            k += 1
    return out


def waiting_gaps(trace, ops: list) -> list:
    """The device's idle stretches that wait on the host (module
    docstring), in order; ``ops`` is ``attribute``'s."""
    lo, hi = trace.window
    out, cursor = [], lo
    for _, s, e, called in ops:
        if s > cursor and called > cursor:
            out.append((cursor, min(s, hi)))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return out


def exposed_host_ms(record):
    """Device ms a traced step or request that waits on a program span
    running on the host (module docstring)."""
    trace, units = _units(record)
    found = attribute(trace, tables())
    if found is None:
        return None
    split = idle_by_span(trace, waiting_gaps(trace, found.ops))
    return sum(v for k, v in split.items() if k != "outside") / 1e3 / units


def self_ms(record, kind: str):
    """Host ms a traced step or request of the spans ``kind``, less their
    child spans."""
    trace, units = _units(record)
    if trace is None:
        return None
    us = [e - s for s, e, k in segments(trace) if k == kind]
    return sum(us) / 1e3 / units if us else None


def _letter(name: str) -> str:
    """A device operation's node kind: a memcpy node runs as a copy
    ("Memcpy DtoD ...") or as the driver's own kernel ("memcpy32_post"),
    the driver's choice, which may differ from one replay to the next."""
    return "C" if name.startswith(("Memcpy", "memcpy")) else (
        "S" if name.startswith(("Memset", "memset")) else "K")


def _name(name: str) -> str:
    """A device operation's name as every replay of its node gives it."""
    letter = _letter(name)
    return name if letter == "K" else letter


SHIFTS = (0, -1, 1, -2, 2, -3, 3)  # where a replay's block is looked for


class _NotExact(Exception):
    """The stretch's operations do not add up."""
HOST = "host"       # an operation enqueued outside a graph
UNMAPPED = "?"      # an operation of a replay that did not map one for one


@dataclass
class Attribution:
    """``ops``: every device operation of the stretch in stream order,
    ``(owner, start_us, end_us, enqueued_us)``, ``owner`` the scope that
    owns a mapped replay's operation (None outside every scope), ``HOST``
    or ``UNMAPPED``, ``enqueued_us`` the end of the host call that
    enqueued it; ``mapped`` of ``replays`` replays mapped one for one."""
    ops: list
    mapped: int
    replays: int


def attribute(trace, tabs):
    """The stretch's ``Attribution`` (module docstring), or None where no
    replay maps one for one or the mapped replays disagree."""
    if trace is None or not tabs:
        return None
    replays = []
    for kind, ids, s, e in spans(trace):
        if kind == "graph.replay":
            table = tabs.get(int(ids.get("graph", -1)))
            if table is None or table.rows is None:
                return None
            replays.append((s, e, table))
    if not replays:
        return None
    ops = sorted(trace.device, key=lambda r: (r[1], r[2]))
    calls = sorted((s, e) for name, s, e in trace.host if LAUNCH.match(name))
    starts = [s for s, _ in calls]
    cuts = [bisect.bisect_left(starts, s) for s, _, _ in replays]
    # operations enqueued by calls before replay k (after replay k - 1),
    # and after the last
    hosts = [b - a for a, b in zip([0] + cuts, cuts + [len(calls)])]

    K = len(replays)

    def locate(ref):
        """Each replay's first operation where its block maps (else
        None), and the blocks' kernels; with ``ref``, a block's kernels
        must be its table's there."""
        at, seqs, i = [None] * K, [], 0
        for k in range(K):
            i += hosts[k]
            start, _, table = replays[k]
            # a record lost or split before the block moves it by a few
            for d in SHIFTS:
                block = ops[i + d:i + d + table.total] if i + d >= 0 else []
                if (len(block) != table.total or block[0][1] < start
                        or "".join(_letter(n) for n, _, _ in block)
                        != table.types):
                    continue
                seq = tuple(_name(n) for n, _, _ in block)
                if ref is None or ref.get(table.id) == seq:
                    at[k] = i = i + d
                    seqs.append((table.id, seq))
                    break
            i += table.total
        return at, seqs

    # the kernels of a table's blocks, as most of its replays give them
    votes = Counter(locate(None)[1])
    ref = {}
    for (tid, seq), _ in votes.most_common():
        ref.setdefault(tid, seq)
    at = locate(ref)[0] if ref else [None] * K
    mapped = [k for k in range(K) if at[k] is not None]
    if not mapped:
        return None
    out, i, rest = [], 0, iter(calls)

    def host(n, n_calls):
        """The next ``n`` operations, enqueued by the next ``n_calls``
        launch calls (one for one, but where a record was lost or split)."""
        nonlocal i
        if n < 0:
            raise _NotExact
        ends = [next(rest)[1] for _ in range(n_calls)]
        for j, (_, s, e) in enumerate(ops[i:i + n]):
            out.append((HOST, s, e,
                        ends[min(j, n_calls - 1)] if ends else -math.inf))
        i += n

    try:
        k = 0
        while k < K:
            if at[k] is not None:
                host(at[k] - i, hosts[k])
                _, end, table = replays[k]
                for scope, f, n in table.rows:
                    out.extend((scope, s, e, end)
                               for _, s, e in ops[i + f:i + f + n])
                i += table.total
                k += 1
                continue
            # replays k..m-1 did not map: each takes its share of what
            # lies between the mapped replays around them
            m = next((x for x in range(k + 1, K) if at[x] is not None), K)
            stop = at[m] - hosts[m] if m < K else len(ops) - hosts[K]
            host(hosts[k], hosts[k])
            left = stop - i - sum(hosts[k + 1:m])
            if left < 0:
                return None
            for x in range(k, m):
                if x > k:
                    host(hosts[x], hosts[x])
                _, end, table = replays[x]
                n = left if x == m - 1 else min(table.total, left)
                out.extend((UNMAPPED, s, e, end) for _, s, e in ops[i:i + n])
                i += n
                left -= n
            k = m
        host(len(ops) - i, hosts[K])
    except _NotExact:
        return None
    return Attribution(out, len(mapped), K)


def scope_ms(record, scope: str):
    """Device ms a traced step of the replays' operations in ``scope``,
    over the replays mapped one for one."""
    trace, units = _units(record)
    found = attribute(trace, tables())
    if found is None:
        return None
    us = [e - s for owner, s, e, _ in found.ops if owner == scope]
    if not us:
        return None
    return sum(us) / found.mapped * found.replays / 1e3 / units


def scope_ops(record, scope: str):
    """Graph nodes a traced step in ``scope``: the tables' counters over
    the stretch's replays."""
    trace, units = _units(record)
    tabs = tables()
    if trace is None or not tabs:
        return None
    n = 0
    for kind, ids, _, _ in spans(trace):
        if kind == "graph.replay":
            table = tabs.get(int(ids.get("graph", -1)))
            if table is None or table.counts is None:
                return None
            n += table.counts.get(scope, 0)
    return n / units if n else None
