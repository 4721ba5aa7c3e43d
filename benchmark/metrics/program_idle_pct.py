"""program_idle_pct: the share of the traced slice's wall time in which
no device op ran while a ``two_hop.batch`` range of the program was open
on the host (the card idle while the program enqueued a batch).  Read
from the profiler's host ranges and device ops; nothing when the trace
holds no such range."""

from benchmark.trace import merged

BATCH = "two_hop.batch"


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    lo, hi = t.window
    open_ = merged([(max(s, lo), min(e, hi)) for n, s, e in t.host
                    if n == BATCH and e > lo and s < hi])
    if not open_:
        return None
    busy = merged([(max(s, lo), min(e, hi)) for _n, s, e in t.device
                   if e > lo and s < hi])
    idle, j = 0.0, 0
    for s, e in open_:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return 100.0 * idle / (hi - lo)
