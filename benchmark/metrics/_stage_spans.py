"""The program's stage spans as the per-layer readers see them: the
totals by span name that ``dgraph_tpu_torch.obs.span_totals()`` keeps
while the profiler collects, which is exactly the traced slice.

Nothing is read when the program keeps no totals, when they hold no
``two_hop.batch`` or a count of them other than the traced slice's
batches (totals of another run in the same process), or when a stage
was not timed on a CUDA device (a CPU run)."""

BATCH = "two_hop.batch"


def device_ms_a_batch(run, *names):
    """Device ms of the spans ``names`` together, a ``two_hop.batch``."""
    from dgraph_tpu_torch import obs

    totals = getattr(obs, "span_totals", None)
    if totals is None or run.trace is None:
        return None
    tot = totals()
    batches = tot.get(BATCH, {}).get("count", 0)
    if not batches or batches != run.trace.batches:
        return None
    ms = [tot.get(n, {}).get("device_ms") for n in names]
    if any(v is None for v in ms):
        return None
    return sum(ms) / batches
