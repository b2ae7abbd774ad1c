"""issue_idle_share (executor: the replay loop; on a mesh, the host's issue
to every card): the share of the batches' time in which a card sat idle
while the host was still issuing that batch's work, in %, averaged over
the cards.  A span with no device operation counts when it begins inside
the program's ``tfhe.run`` host span and before that run's last
``tfhe.replay`` (``tfhe.level`` on the eager path) has ended; idle_share
less this is the drain: the closing synchronisation, or waiting for the
slowest card.  Nothing to read without device operations, or where the
host spans do not give one ``tfhe.run`` a batch."""

RUN = "tfhe.run"
ISSUE = ("tfhe.replay ", "tfhe.level ")


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    runs = sorted((a, b) for n, a, b in tr.host if n == RUN)
    if len(runs) != len(tr.windows):
        return None
    issue = []                       # (run start, its last issue span's end)
    for a, b in runs:
        ends = [e for n, s, e in tr.host
                if n.startswith(ISSUE) and a <= s and e <= b]
        if not ends:
            return None
        issue.append((a, max(ends)))
    shares = []
    for dev in tr.devices():
        idle = 0.0
        for (w0, w1), (i0, i1) in zip(tr.windows, issue):
            t = w0
            for a, b in _merged((a, b) for _, a, b in tr.ops[dev]
                                if b > w0 and a < w1):
                if a > t and i0 <= t < i1:
                    idle += a - t
                t = max(t, b)
            if w1 > t and i0 <= t < i1:
                idle += w1 - t
        shares.append(idle / 1e6 / tr.window_s)
    return 100.0 * sum(shares) / len(shares)
