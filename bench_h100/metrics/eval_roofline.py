"""eval_roofline (executor, the whole evaluation): the least time the cards
need for the window's real bootstraps, blind rotation and key switch
(harness/roofline.py), over the batches' host seconds, in %.  It reads the
same work whatever implements it."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * run.least_batch_s * len(run.times) / sum(run.times)
