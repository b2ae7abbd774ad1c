"""Benchmark circuit generators: the port's copy of
``tfhe_fbs_map_tpu.frontend.circuits`` on the port's own
:mod:`..bit_circuit`, writing the same bytes
(``tests/test_torch_circuits.py``).

``generators`` (the generated suite and the EPFL arithmetic members),
``epfl_control`` (the EPFL control members), ``bench_regen`` (the ISCAS85/89
"r" regenerations) and ``aes128`` (the Bristol AES-128 netlist).  Each
writes only where its caller says: ``python -m
tfhe_fbs_map_tpu_torch.frontend.circuits --out DIR``.
"""

from .dsl import Bit, CircuitBuilder
from .generators import BENCH_GENERATORS, EPFL_GENERATORS, build_bench

__all__ = ["Bit", "CircuitBuilder", "BENCH_GENERATORS", "EPFL_GENERATORS",
           "build_bench"]
