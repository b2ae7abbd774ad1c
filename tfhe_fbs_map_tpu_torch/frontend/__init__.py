"""Circuit IRs, parsers, the logic optimizer and FBS mappers (numpy only).

The port's own copy of the modules of ``tfhe_fbs_map_tpu.frontend`` that it
uses, kept equal to them (``tests/test_torch_frontend.py``,
``tests/test_torch_frontend_cli.py``): the bit-level circuit, the ``.lbf``
program IR and its parser, the circuit parsers, the AIG logic optimizer
(``opt.optimize``), the basic and heuristic mappers and the mapping CLI
(``python -m tfhe_fbs_map_tpu_torch.frontend.cli``) and the benchmark
generators (:mod:`.circuits`, ``tests/test_torch_circuits.py``).
"""

from .bit_circuit import BitCircuit, BitNode, CONST0, CONST1
from .lut_program import LutProgram, LutNode, parse_lbf
from .mapping.basic import BasicMapper
from .mapping.heuristic import HeuristicMapper, map_best
from .opt import optimize

__all__ = [
    "BitCircuit", "BitNode", "CONST0", "CONST1",
    "LutProgram", "LutNode", "parse_lbf",
    "BasicMapper", "HeuristicMapper", "map_best", "optimize",
]
