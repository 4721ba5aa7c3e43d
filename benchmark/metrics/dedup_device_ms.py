"""dedup_device_ms: device milliseconds a batch of the program's
``two_hop.dedup`` span over the traced slice (``next_rows``: the
sort-unique of hop 1's targets, the cut to ucap, the decode), timed by
CUDA events on the batch's stream (``dgraph_tpu_torch.obs.span_totals``)."""

from benchmark.metrics._stage_spans import device_ms_a_batch


def read(run):
    return device_ms_a_batch(run, "two_hop.dedup")
