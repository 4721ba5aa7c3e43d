"""ops_device_ms: device milliseconds a batch of every device op in the
traced slice (the ops layer's gathers, sorts, masks and sums) except the
slot-map kernel and the harness's device-to-host copies of the answers."""


def read(run):
    t = run.trace
    if t is None or not t.batches:
        return None
    us = sum(e - s for n, s, e in t.device
             if "slotmap" not in n and not n.startswith("Memcpy DtoH"))
    if us <= 0:
        return None
    return us / 1e3 / t.batches
