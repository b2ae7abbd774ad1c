"""launch_pad_share (executor): padding among the ciphertexts the window's
blind-rotation launches ran, in %, counted by the program at each launch on
every card: 100 × (launched − real) / launched over the entries of the
launch record (``tfhe_fbs_map_tpu_torch.utils.profiling``) of the window's
batches.  pad_share counts the same from the compiled plan; the two part
where the launch layout is not the plan's.  Nothing to read where the
program keeps no record, or where it holds fewer batches than the trace."""


def window(run):
    """The launch record's entries of the window's batches (a list a
    batch), or None."""
    try:
        from tfhe_fbs_map_tpu_torch.utils import profiling
    except ImportError:
        return None
    batches = getattr(profiling, "batches", None)
    n = len(run.times)
    if batches is None or run.trace is None or len(run.trace.windows) != n:
        return None
    return batches(n)


def read(run):
    got = window(run)
    if not got:
        return None
    launched = sum(e.launched for batch in got for e in batch)
    real = sum(e.real for batch in got for e in batch)
    return 100.0 * (launched - real) / launched if launched else None
