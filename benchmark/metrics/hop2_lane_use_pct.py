"""hop2_lane_use_pct: of the target lanes of the (inline2, ov2) that
``two_hop_batch`` returns, the share that hold a hop-2 edge, over every
query the window completed (the rest is the plan's padding).  Lanes a
query gets are read from the returned shapes; its edges are the
reference's count, which the run checks against the lanes of a sample."""


def read(run):
    if not run.queries or not run.lanes_per_query:
        return None
    return 100.0 * run.hop2_edges / (run.queries * run.lanes_per_query)
