"""The harness: cells and their files (``spec``), set-up and the measured
window (``cell``), the profiler's trace reduced (``trace``), the frozen
operation and byte counts (``roofline``)."""
