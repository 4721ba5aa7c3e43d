"""plan_s: host seconds of ``bench2hop.prepare`` at set-up (the layout
already built): capacity planning over the pool and stacking the seed
frontiers onto the card."""


def read(run):
    return run.plan_s
