"""overflow_gather_device_ms: device milliseconds a batch of the
program's ``expand.overflow`` spans over the traced slice, both hops
together: the ``ov_chunks[chunkid]`` gather over every planned overflow
lane, timed by CUDA events on the batch's stream
(``dgraph_tpu_torch.obs.span_totals``)."""

from benchmark.metrics._stage_spans import device_ms_a_batch


def read(run):
    return device_ms_a_batch(run, "expand.overflow")
