"""dispatch_ms: host milliseconds from a call of ``two_hop_batch`` to its
return (the enqueue, before the fetch), the mean over the untraced
batches of the window."""

import numpy as np


def read(run):
    phase = run.window if run.window is not None and run.window.dispatch_s else run.traced
    if phase is None or not phase.dispatch_s:
        return None
    return float(np.mean(phase.dispatch_s)) * 1e3
