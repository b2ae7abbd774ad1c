"""Operator-overloading bit DSL for writing benchmark circuits.

Equivalent of the reference's ``Bit`` DSL
(``experiments/generate_benchmarks.py:6-36``) but bound to an
explicit :class:`BitCircuit` instance instead of a class-global environment.
"""

from __future__ import annotations

from ..bit_circuit import BitCircuit, BitNode, CONST0, CONST1

__all__ = ["Bit", "CircuitBuilder"]


class Bit:
    __slots__ = ("builder", "node")

    def __init__(self, builder: "CircuitBuilder", node: BitNode):
        self.builder = builder
        self.node = node

    def output(self, name: str | None = None) -> "Bit":
        self.builder.circuit.set_output(
            name if name else self.node.name, self.node)
        return self

    def _wrap(self, node: BitNode) -> "Bit":
        return Bit(self.builder, node)

    def __and__(self, other: "Bit") -> "Bit":
        return self._wrap(self.builder.circuit.and_(self.node, other.node))

    def __or__(self, other: "Bit") -> "Bit":
        return self._wrap(self.builder.circuit.or_(self.node, other.node))

    def __xor__(self, other: "Bit") -> "Bit":
        return self._wrap(self.builder.circuit.xor_(self.node, other.node))

    def __invert__(self) -> "Bit":
        return self._wrap(self.builder.circuit.not_(self.node))


class CircuitBuilder:
    """Factory tying :class:`Bit` values to one circuit under construction."""

    def __init__(self):
        self.circuit = BitCircuit()

    def input(self, name: str) -> Bit:
        return Bit(self, self.circuit.add_input(name))

    def const(self, val: int) -> Bit:
        return Bit(self, CONST1 if val else CONST0)

    def inputs(self, fmt: str, n: int) -> list[Bit]:
        return [self.input(fmt.format(k)) for k in range(n)]
