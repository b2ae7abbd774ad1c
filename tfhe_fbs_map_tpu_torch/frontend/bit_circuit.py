"""Source-level Boolean circuit IR.

``BitCircuit`` is the source IR of the framework: a topologically ordered DAG of
Boolean gates (generic LUTs over 1..k inputs) with named inputs and outputs.  It
plays the role of the reference's ``BitExecEnv``
(``fbs_mapper/bit_exec_env.py:5-279``) with the same observable
semantics:

* builder API with constant folding for not/and/xor/or,
* MSB-first input indexing in both ``eval`` and BLIF truth tables
  (reference ``bit_exec_env.py:183-185``),
* vectorized cleartext evaluation over numpy arrays,
* reverse-sweep dead-code elimination,
* BLIF export that re-encodes each truth table with the sparser polarity
  (reference ``bit_exec_env.py:247-279``).

The implementation is array-oriented rather than a class-per-gate hierarchy:
every node is a ``BitNode`` with an integer id, a `kind` tag and a dense truth
table, which keeps the mapper's hot loops free of isinstance dispatch.
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np

__all__ = ["BitNode", "BitCircuit", "CONST0", "CONST1"]

# Node kind tags. `kind` is provenance metadata used only for stats; all gate
# semantics are carried by the truth table.
K_CONST = "const"
K_INPUT = "input"
K_LUT = "lut"
K_AND = "and"
K_XOR = "xor"
K_OR = "or"
K_NOT = "not"

_GATE_KINDS = (K_LUT, K_AND, K_XOR, K_OR, K_NOT)


class BitNode:
    """A single circuit node (constant, input, or LUT gate)."""

    __slots__ = ("nid", "name", "kind", "fanins", "table")

    def __init__(self, nid: int, name: str, kind: str,
                 fanins: tuple["BitNode", ...] = (),
                 table: tuple[int, ...] = ()):
        self.nid = nid
        self.name = name
        self.kind = kind
        self.fanins = fanins
        self.table = table

    @property
    def is_gate(self) -> bool:
        return self.kind in _GATE_KINDS

    def __repr__(self) -> str:
        if self.kind == K_CONST:
            return self.name
        if self.kind == K_INPUT:
            return f"Input({self.name})"
        ins = ", ".join(f.name for f in self.fanins)
        return f"{self.kind.upper()}([{ins}], {list(self.table)})"


# Shared constant nodes. Like the reference's ``CONST0/CONST1`` singletons
# (``bit_exec_env.py:18-19``) they are never part of a circuit's node list;
# evaluation seeds the wire environment with their values.
CONST0 = BitNode(-1, "0", K_CONST)
CONST1 = BitNode(-2, "1", K_CONST)


class BitCircuit:
    """Builder + interpreter for Boolean gate DAGs."""

    def __init__(self):
        self.nodes: list[BitNode] = []          # topological order
        self.inputs: list[BitNode] = []
        self.outputs: dict[str, BitNode] = {}
        self._names: set[str] = set()
        self._auto_id = 0

    # ------------------------------------------------------------------ build
    def _fresh_name(self, name: str | None) -> str:
        if name is None:
            while True:
                self._auto_id += 1
                name = f"n{self._auto_id}"
                if name not in self._names:
                    break
        else:
            assert name not in self._names, f"duplicate node name {name!r}"
        self._names.add(name)
        return name

    def _append(self, node: BitNode) -> BitNode:
        self.nodes.append(node)
        return node

    def add_input(self, name: str) -> BitNode:
        node = self._append(BitNode(len(self.nodes), name, K_INPUT))
        self.inputs.append(node)
        return node

    def set_output(self, name: str, node: BitNode) -> None:
        assert isinstance(node, BitNode), "expected BitNode"
        self.outputs[name] = node

    def lut(self, fanins: Sequence[BitNode], table: Sequence[int],
            name: str | None = None, kind: str = K_LUT) -> BitNode:
        fanins = tuple(fanins)
        table = tuple(int(v) for v in table)
        assert len(table) == 1 << len(fanins), "truth table length mismatch"
        assert min(table) == 0 and max(table) == 1, "truth table must be 0/1"
        for f in fanins:
            assert isinstance(f, BitNode), "expected BitNode fanin"
        return self._append(
            BitNode(len(self.nodes), self._fresh_name(name), kind, fanins, table))

    def not_(self, a: BitNode, name: str | None = None) -> BitNode:
        if a is CONST0:
            return CONST1
        if a is CONST1:
            return CONST0
        return self.lut([a], (1, 0), name, kind=K_NOT)

    def and_(self, a: BitNode, b: BitNode, name: str | None = None) -> BitNode:
        if a is CONST0 or b is CONST0:
            return CONST0
        if a is CONST1:
            return b
        if b is CONST1:
            return a
        if a is b:        # x AND x = x (aliased wires after const folding)
            return a
        assert a.name != b.name, "and_ with identical fanins"
        return self.lut([a, b], (0, 0, 0, 1), name, kind=K_AND)

    def xor_(self, a: BitNode, b: BitNode, name: str | None = None) -> BitNode:
        if a is CONST0:
            return b
        if a is CONST1:
            return self.not_(b)
        if b is CONST0:
            return a
        if b is CONST1:
            return self.not_(a)
        if a is b:        # x XOR x = 0 (aliased wires after const folding)
            return CONST0
        assert a.name != b.name, "xor_ with identical fanins"
        return self.lut([a, b], (0, 1, 1, 0), name, kind=K_XOR)

    def or_(self, a: BitNode, b: BitNode, name: str | None = None) -> BitNode:
        if a is CONST1 or b is CONST1:
            return CONST1
        if a is CONST0:
            return b
        if b is CONST0:
            return a
        if a is b:        # x OR x = x (aliased wires after const folding)
            return a
        assert a.name != b.name, "or_ with identical fanins"
        return self.lut([a, b], (0, 1, 1, 1), name, kind=K_OR)

    # ------------------------------------------------------------------ eval
    def eval(self, input_values: dict[str, np.ndarray | Sequence[int]]
             ) -> dict[str, np.ndarray]:
        """Vectorized cleartext evaluation.

        Gate input index is MSB-first: ``fanins[0]`` is the most significant
        bit of the truth-table row index (reference ``bit_exec_env.py:183-185``).

        Wires are resolved by node identity (``nid``), not name — ISCAS
        ``.bench`` netlists legally name wires "0"/"1", which must not
        collide with the CONST0/CONST1 singletons.
        """
        wires: dict[int, np.ndarray] = {CONST0.nid: np.int64(0),
                                        CONST1.nid: np.int64(1)}
        for node in self.nodes:
            if node.kind == K_INPUT:
                val = np.asarray(input_values[node.name]).reshape(-1)
            else:
                idx = 0
                for f in node.fanins:
                    idx = (idx << 1) + wires[f.nid]
                val = np.asarray(node.table, dtype=np.int64)[idx]
            wires[node.nid] = val

        return {name: wires[out.nid] for name, out in self.outputs.items()}

    # ------------------------------------------------------------- transforms
    def remove_dangling_nodes(self) -> None:
        """Drop gates not reachable from any output (reverse sweep)."""
        live = {out.name for out in self.outputs.values()}
        for node in reversed(self.nodes):
            if node.name in live and node.is_gate:
                live.update(f.name for f in node.fanins)
        # `self.inputs` is intentionally left untouched: the input interface of
        # the circuit is part of its signature even when some inputs are unused
        # (mirrors reference ``bit_exec_env.py:196-206``).
        self.nodes = [n for n in self.nodes if n.name in live]

    # ------------------------------------------------------------------ info
    def stats(self) -> dict:
        counts = {K_AND: 0, K_XOR: 0, K_NOT: 0, K_LUT: 0, K_OR: 0}
        nb_inp = 0
        max_lut_inputs = 0
        max_lut_size = 0
        for node in self.nodes:
            if node.kind == K_INPUT:
                nb_inp += 1
            elif node.is_gate:
                counts[node.kind] += 1
                max_lut_inputs = max(max_lut_inputs, len(node.fanins))
                max_lut_size = max(max_lut_size, len(node.table))
        return dict(
            nb_inp=nb_inp,
            nb_and=counts[K_AND],
            nb_xor=counts[K_XOR],
            nb_not=counts[K_NOT],
            nb_lut=counts[K_LUT] + counts[K_OR],
            max_lut_inputs=max_lut_inputs,
            max_lut_size=max_lut_size,
            nb_out=len(self.outputs),
        )

    def print(self, os=sys.stdout, show_inputs: bool = True,
              show_outputs: bool = True) -> None:
        for node in self.nodes:
            if node.kind == K_INPUT and not show_inputs:
                continue
            print(f"{node.name} = {node!r}", file=os)
        if show_outputs:
            for name, out in self.outputs.items():
                print(f"Output {name} = {out.name}", file=os)

    # ------------------------------------------------------------------- I/O
    def to_blif(self, fs=sys.stdout, model_name: str = "test") -> None:
        """BLIF export; picks the sparser cover polarity per truth table."""

        def cover(table: tuple[int, ...]) -> str:
            # List the rarer polarity so the cover stays small
            # (reference ``bit_exec_env.py:248-254``).
            val = 1 if np.mean(table) <= 0.5 else 0
            nbits = int(np.log2(len(table)))
            rows = [f"{idx:0{nbits}b} {val}"
                    for idx, v in enumerate(table) if v == val]
            return "\n".join(rows)

        print(f".model {model_name}", file=fs)
        print(f".inputs {' '.join(i.name for i in self.inputs)}", file=fs)
        print(f".outputs {' '.join(self.outputs.keys())}", file=fs)

        consts_emitted = set()
        for node in self.nodes:
            if node.kind == K_INPUT:
                continue
            print(f".names {' '.join(f.name for f in node.fanins)} {node.name}",
                  file=fs)
            print(cover(node.table), file=fs)

        for name, out in self.outputs.items():
            if out.kind == K_CONST and out.name not in consts_emitted:
                # constant output: emit a .names stanza defining it
                consts_emitted.add(out.name)
                print(f".names CONST{out.name}", file=fs)
                print(f"{out.name}", file=fs)
            if out.name != name:
                src = f"CONST{out.name}" if out.kind == K_CONST else out.name
                print(f".names {src} {name}\n1 1", file=fs)

        print(".end", file=fs)
