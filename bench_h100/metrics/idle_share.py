"""idle_share (device): the share of the timed batches' spans in which the
device ran no operation, in %, from the profiler's trace, averaged over
the cell's devices."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    shares = [1.0 - tr.busy_s(d) / tr.window_s for d in tr.devices()]
    return 100.0 * sum(shares) / len(shares)
