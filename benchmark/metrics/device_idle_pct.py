"""device_idle_pct: the share of the traced slice's wall time in which no
device op ran (100 less the union of the device intervals)."""


def read(run):
    t = run.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
