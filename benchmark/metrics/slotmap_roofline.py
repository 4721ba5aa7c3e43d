"""slotmap_roofline: the slot-map kernel's share of its memory roofline
over the traced slice: the least bytes of its launches (two a batch, at
the plan's hop-1 and hop-2 shapes) over 3.35 TB/s, divided by its device
time by name.  Nothing is read unless the trace holds exactly two
launches a batch."""

from benchmark.roofline import HBM_BYTES_PER_S, slotmap_bytes


def read(run):
    t = run.trace
    if t is None or not t.batches:
        return None
    spans = [(s, e) for n, s, e in t.device if "slotmap" in n]
    if len(spans) != 2 * t.batches:
        return None
    secs = sum(e - s for s, e in spans) / 1e6
    p, q = run.plan, run.batch_q
    nbytes = t.batches * (slotmap_bytes(q, p["pcap1"], p["capo1"])
                          + slotmap_bytes(q, p["pcap2"], p["capo2"]))
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
