"""edges_per_s: hop-1 plus hop-2 edges of every query the untraced
window completed, as the reference counts them, over that window's
seconds."""


def read(run):
    if run.window is None or run.window.seconds <= 0:
        return None
    return run.window.edges / run.window.seconds
