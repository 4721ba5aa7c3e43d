"""Cohort scheduler (copy of ``dgraph_tpu.sched``): continuous
micro-batching of concurrent read queries onto the engine, with their
same-predicate hops merged into one gather launch (scheduler.py /
cohort.py), segment seams in the fused hop loops (segments.py), and
multi-tenant QoS — per-tenant quotas, weighted-fair cohort pick, and
cooperative cancellation (qos.py)."""

from dgraph_tpu_torch.sched.cohort import (
    Cohort,
    HopMerger,
    SchedDeadlineError,
    SchedOverloadError,
    SchedQuotaError,
    SchedRequest,
    hop_signature,
)
from dgraph_tpu_torch.sched.qos import (
    CancelToken,
    QueryCancelledError,
    qos_enabled,
)
from dgraph_tpu_torch.sched.scheduler import CohortScheduler, sched_enabled

__all__ = [
    "CancelToken",
    "Cohort",
    "CohortScheduler",
    "HopMerger",
    "QueryCancelledError",
    "SchedDeadlineError",
    "SchedOverloadError",
    "SchedQuotaError",
    "SchedRequest",
    "hop_signature",
    "qos_enabled",
    "sched_enabled",
]
