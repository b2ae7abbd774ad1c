"""Device paths of the bootstrap: polynomial helpers, the fast-path key
layouts and key switch (:mod:`.blind_rotate`), and the fused blind-rotation
CUDA kernels with their plain versions (:mod:`.fused_blind_rotate`)."""
