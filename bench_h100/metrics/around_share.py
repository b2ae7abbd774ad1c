"""around_share (FBS fast path): device time outside the blind-rotation
kernels (key switch, modswitch, sample extract, gather, lincomb, scatter,
copies) over device busy time, in %, from the profiler's trace."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    busy = sum(tr.busy_s(d) for d in tr.devices())
    rot = sum(tr.rotation_s(d) for d in tr.devices())
    return 100.0 * (busy - rot) / busy if busy > 0 else None
