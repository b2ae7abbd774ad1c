"""Device paths of the bootstrap: polynomial helpers (:mod:`.polymul`), the
fast-path key layouts, key switch and the XLA-scan orientations
(:mod:`.blind_rotate`), and the fused blind-rotation CUDA kernels with
their plain versions (:mod:`.fused_blind_rotate`)."""

from .polymul import (monomial_rotate, negacyclic_matrix, negacyclic_polymul,
                      np_negacyclic_polymul)

__all__ = ["monomial_rotate", "negacyclic_matrix", "negacyclic_polymul",
           "np_negacyclic_polymul"]
