"""Circuit IRs, parsers and FBS mappers (numpy only).

The port's own copy of the modules of ``tfhe_fbs_map_tpu.frontend`` that it
uses, kept equal to them (``tests/test_torch_frontend.py``): the bit-level
circuit, the ``.lbf`` program IR and its parser, the circuit parsers and the
basic and heuristic mappers.  The circuit generators and the circuit
optimizer are not copied: the port does not use them.
"""

from .bit_circuit import BitCircuit, BitNode, CONST0, CONST1
from .lut_program import LutProgram, LutNode, parse_lbf
from .mapping.basic import BasicMapper
from .mapping.heuristic import HeuristicMapper, map_best

__all__ = [
    "BitCircuit", "BitNode", "CONST0", "CONST1",
    "LutProgram", "LutNode", "parse_lbf",
    "BasicMapper", "HeuristicMapper", "map_best",
]
