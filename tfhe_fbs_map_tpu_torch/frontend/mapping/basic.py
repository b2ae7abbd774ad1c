"""Baseline mapper: one functional bootstrap per multi-input gate.

Equivalent of the reference ``MapToFBSBasic``
(``fbs_mapper/map_to_fbs.py:15-51``): gate inputs are weighted
by powers of two so the gate truth table becomes the bootstrap test vector
verbatim; 1-input gates become the identity or the lincomb ``1 - x``.  Used as
the "every gate bootstraps" cost baseline (``mapper=basic``, fbs_size 2).
The reference's unbound-name crash on Const instructions
(``map_to_fbs.py:25``) does not apply: constants are handled via the seeded
wire environment.
"""

from __future__ import annotations


from ..bit_circuit import BitCircuit, CONST0, CONST1, K_CONST, K_INPUT
from ..lut_program import LutProgram

__all__ = ["BasicMapper"]


class BasicMapper:
    def map(self, circuit: BitCircuit) -> LutProgram:
        prog = LutProgram(fbs_size=2)
        # wires keyed by node identity (nid) — .bench netlists name wires
        # "0"/"1", which must not be mistaken for the constant singletons
        wires = {CONST0.nid: prog.const(0), CONST1.nid: prog.const(1)}

        for node in circuit.nodes:
            if node.kind == K_INPUT:
                wires[node.nid] = prog.input(node.name)
                continue
            assert len(node.table) == 1 << len(node.fanins)

            # Partial-evaluate constant fanins (fixes the reference's crash on
            # const-input gates, ``map_to_fbs.py:25``): restrict the truth
            # table to the rows selected by each constant value.
            fanins, table = list(node.fanins), list(node.table)
            pos = 0
            while pos < len(fanins):
                f = fanins[pos]
                if f.kind == K_CONST:
                    bit = 0 if f is CONST0 else 1
                    stride = 1 << (len(fanins) - pos - 1)
                    table = [v for r, v in enumerate(table)
                             if (r // stride) % 2 == bit]
                    fanins.pop(pos)
                else:
                    pos += 1

            if not fanins:
                wires[node.nid] = prog.const(table[0])
            elif len(fanins) == 1:
                src = wires[fanins[0].nid]
                if table == [1, 0]:
                    wires[node.nid] = prog.linear([-1], [src], const_coef=1)
                elif table == [0, 1]:
                    wires[node.nid] = src
                else:  # constant table after partial evaluation
                    wires[node.nid] = prog.const(table[0])
            else:
                # MSB-first binary weighting: fanins[0] gets the top bit.
                coefs = [1 << k for k in range(len(fanins))][::-1]
                vals = [wires[f.nid] for f in fanins]
                lin = prog.linear(coefs, vals)
                wires[node.nid] = prog.bootstrap(lin, table)

        for name, out in circuit.outputs.items():
            prog.output(name, wires[out.nid])
        return prog
