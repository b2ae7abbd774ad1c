"""pad_share (executor): padding bootstrap slots over launched slots, in %,
counted from the compiled plan's levels (each level's calls padded to a
power of two)."""


def read(run):
    return 100.0 * (run.slots - run.real) / run.slots if run.slots else None
