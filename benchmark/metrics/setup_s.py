"""setup_s: from the process's start to the window: imports, the card,
data generation, arena and layout, the plan, the warm-up over every batch
of the pool (and the kernel build on a checkout's first run)."""


def read(run):
    return run.setup_s
