"""Plain reading of a ``.lbf`` program and its plaintext evaluation.

A frozen copy of the format's semantics, kept apart from the program under
test: inputs, integer lincombs and table lookups ("bootstraps"), with the
format's structural sharing (an instruction equal to an earlier one is that
one), nested lincombs flattened and constants folded.  The node order it
yields is the order in which the format's reader creates nodes, so the k-th
input-or-bootstrap node is the k-th row of an executor's wire buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["Node", "Program", "read_lbf"]


@dataclass
class Node:
    kind: str                                   # "input" | "lin" | "boot"
    name: str
    terms: list = field(default_factory=list)   # lin: [(coef, node index)]
    const: int = 0                              # lin: constant term
    src: int = -1                               # boot: input node index
    table: tuple = ()                           # boot: lookup table


@dataclass
class Program:
    nodes: list
    outputs: dict          # name -> ("node", index) | ("const", value)
    fbs_size: int | None

    def rows(self) -> dict:
        """Node index -> wire row, for the inputs and bootstraps in node
        order; the row after the last is the executor's dummy row."""
        kinds = ("input", "boot")
        return {i: r for r, i in enumerate(
            i for i, n in enumerate(self.nodes) if n.kind in kinds)}

    def evaluate(self, inputs: dict) -> list:
        """Every node's value (int64 arrays over the evaluations) for the
        input bits ``inputs`` (name -> array)."""
        vals: list = []
        for n in self.nodes:
            if n.kind == "input":
                v = np.asarray(inputs[n.name], dtype=np.int64)
            elif n.kind == "lin":
                v = np.int64(n.const)
                for c, j in n.terms:
                    v = v + c * vals[j]
            else:
                v = np.asarray(n.table, dtype=np.int64)[vals[n.src]]
            vals.append(v)
        return vals


def read_lbf(text: str) -> Program:
    text = text.replace("\\\n", " ")
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    nodes: list[Node] = []
    shared: dict = {}
    wires: dict[str, int] = {}
    outputs: list[str] = []
    alias: dict[str, str] = {}
    fbs_size = None

    def intern(key, node: Node) -> int:
        if key not in shared:
            node.name = node.name or f"m{len(shared) + 1}"
            shared[key] = len(nodes)
            nodes.append(node)
        return shared[key]

    i = 0
    while i < len(lines):
        head = lines[i].split()
        if head[0] == ".fbs_size":
            fbs_size = int(head[1])
            i += 1
        elif head[0] == ".inputs":
            for name in head[1:]:
                wires[name] = intern(("inp", name), Node("input", name))
            i += 1
        elif head[0] == ".outputs":
            outputs += head[1:]
            i += 1
        elif head[0] == ".lincomb":
            srcs, dst = head[1:-1], head[-1]
            row = [int(x) for x in lines[i + 1].split()]
            coefs, const = row[:len(srcs)], (row[len(srcs)]
                                             if len(row) > len(srcs) else 0)
            if dst in outputs and len(srcs) == 1 and coefs == [1] \
                    and const == 0:
                alias[dst] = srcs[0]
            else:
                terms = []
                for c, s in zip(coefs, srcs):
                    if s not in wires:                  # a literal constant
                        const += c * int(s)
                    elif nodes[wires[s]].kind == "lin":  # flatten
                        inner = nodes[wires[s]]
                        terms += [(c * c1, j) for c1, j in inner.terms]
                        const += c * inner.const
                    else:
                        terms.append((c, wires[s]))
                key = ("lin", tuple(terms), const)
                wires[dst] = intern(key, Node("lin", "", terms, const))
            i += 2
        elif head[0] == ".bootstrap":
            src, dst = wires[head[1]], head[2]
            table = tuple(int(ch) for ch in lines[i + 1])
            wires[dst] = intern(("boot", src, table),
                                Node("boot", "", src=src, table=table))
            i += 2
        else:
            raise ValueError(f"unknown .lbf stanza: {lines[i]!r}")

    outs = {}
    for name in outputs:
        src = alias.get(name, name)
        outs[name] = ("node", wires[src]) if src in wires \
            else ("const", int(src))
    return Program(nodes, outs, fbs_size)
