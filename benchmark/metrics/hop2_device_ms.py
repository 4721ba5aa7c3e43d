"""hop2_device_ms: device milliseconds a batch of the program's
``two_hop.hop2`` span over the traced slice (the second
``expand_inline_grouped_kernel`` call), timed by CUDA events on the
batch's stream (``dgraph_tpu_torch.obs.span_totals``)."""

from benchmark.metrics._stage_spans import device_ms_a_batch


def read(run):
    return device_ms_a_batch(run, "two_hop.hop2")
