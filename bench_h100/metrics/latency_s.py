"""latency_s: the window's seconds over the evaluations it completed; at
batch 1, the seconds one client waits for one evaluation."""


def read(run):
    return sum(run.times) / (run.batch * len(run.times))
