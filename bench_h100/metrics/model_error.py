"""model_error (cost model, ``optimizer/runtime_model.py``): how far the
runtime model's price of each family call lies from the card's time for
it, 100 × Σ|pred − meas| / Σ meas over the window's blind-rotation
launches, in %.

``pred`` is ``runtime_model.launch_us`` at the call's family, ciphertexts
launched and kernel (the launch record, ``utils.profiling``), at the
configuration's key limbs.  ``meas`` is the card's busy time from the end
of the previous call's blind-rotation kernel to the end of this call's
(for a batch's first, from its first device operation).  On each card the
i-th blind-rotation kernel of a batch in the trace is the i-th fused-kernel
entry (k1, k1s, k2) of that card's record, the trace's devices and the
record's paired in order, and a kernel counts in the batch it ends in.  Nothing to read where the program keeps no
record, or where the trace and the record differ in their count of cards,
or of a card's kernels in a batch."""

import bisect

ORIENTATION = {"k1": "fused_otf", "k1s": "fused_otf", "k2": "fused"}


def _window(run):
    """The launch record's entries of the window's batches (a list a
    batch), or None."""
    try:
        from tfhe_fbs_map_tpu_torch.utils import profiling
    except ImportError:
        return None
    batches = getattr(profiling, "batches", None)
    n = len(run.times)
    if batches is None or len(run.trace.windows) != n:
        return None
    return batches(n)


def _ordinal(device: str) -> int:
    return int(device.rpartition(":")[2] or 0)


class _Busy:
    """Busy µs of one card's operations before a time (a prefix sum over
    their union)."""

    def __init__(self, spans):
        self.starts, self.ends, self.before = [], [], [0.0]
        for a, b in sorted(spans):
            if self.ends and a <= self.ends[-1]:
                if b > self.ends[-1]:
                    self.before[-1] += b - self.ends[-1]
                    self.ends[-1] = b
                continue
            self.starts.append(a)
            self.ends.append(b)
            self.before.append(self.before[-1] + b - a)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    got = _window(run)
    if not got:
        return None
    from bench_h100.harness.trace import is_blind_rotation
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import launch_us
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams

    cfg = run.cell.config
    fams = [TFHEParams(**f) for f in cfg["families"]]
    params = {"native": fams[0], "fam1": fams[0], "fam2": fams[-1]}
    # the trace's devices and the record's, each in order
    devices = tr.devices()
    cards = sorted({e.device for batch in got for e in batch
                    if e.path in ORIENTATION}, key=_ordinal)
    if len(cards) != len(devices):
        return None
    err = total = 0.0
    for (w0, w1), batch in zip(tr.windows, got):
        calls = [e for e in batch if e.path in ORIENTATION]
        for dev, card in zip(devices, cards):
            ops = [(a, b, n) for n, a, b in tr.ops[dev] if b > w0 and a < w1]
            busy = _Busy((a, b) for a, b, _ in ops)
            # a kernel counts in the batch it ends in: the host syncs every
            # card at a batch's end, so a piece the window cuts at its end
            # is a timestamp off by the gap between batches (seen on four
            # cards), and its other piece is counted in the next batch
            kernels = sorted(b for a, b, n in ops
                             if is_blind_rotation(n) and b < w1)
            mine = [e for e in calls if e.device == card]
            if len(kernels) != len(mine):
                return None
            start = min((a for a, _, _ in ops), default=w0)
            for end, e in zip(kernels, mine):
                meas = busy.upto(end) - busy.upto(start)
                pred = launch_us(params[e.family], e.launched,
                                 ORIENTATION[e.path], int(cfg["bsk_limbs"]),
                                 bool(cfg["staged"]))
                err += abs(pred - meas)
                total += meas
                start = end
    return 100.0 * err / total if total > 0 else None
