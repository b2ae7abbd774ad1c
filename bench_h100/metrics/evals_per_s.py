"""evals_per_s: circuit evaluations completed in the window over the
window's seconds (the sum of the batches' host times)."""


def read(run):
    return run.batch * len(run.times) / sum(run.times)
