"""query_p95_ms: the 95th percentile, over every query the window
completed, of the time from its batch's submission to its answers being
on the host (the queries of one batch share one latency)."""

import numpy as np


def read(run):
    if run.window is None or not run.window.latency_s:
        return None
    per_query = np.repeat(np.asarray(run.window.latency_s), run.batch_q)
    return float(np.percentile(per_query, 95)) * 1e3
