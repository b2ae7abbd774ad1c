"""AIG-based logic optimization for parsed circuits.

Plays the role of the abc preprocessing step in the reference pipeline
(``experiments/gen_makefile_iscas85.bash:41`` runs
``read_bench; read_library lib.genlib; map; unmap`` — i.e. structural
hashing into an AND-inverter graph followed by technology mapping onto a
12-gate 2-input library with zero-cost inverters,
``experiments/lib.genlib:1-39``).  The equivalent here:

* **strash**: every gate is reduced to AND nodes over complemented-edge
  literals with structural hashing (identical subexpressions are shared)
  and constant/trivial-rule propagation (``x∧x=x``, ``x∧¬x=0``, …);
* **XOR recollapse**: the canonical strashed XOR shape
  ``¬(¬(p∧q) ∧ ¬(¬p∧¬q))`` is matched and emitted as a single 2-input
  XOR/XNOR LUT when its internal ANDs have no other fanout (the job the
  genlib XOR/XNOR cells do during ``map``);
* **free inverters**: complemented edges are folded into the consuming
  gate's truth table (the genlib gives NOT/BUF area 0; the FBS mapper
  likewise evaluates input polarities for free inside LUT tables).

The result is a 2-input-LUT :class:`BitCircuit` with the same I/O
signature and identical cleartext semantics, typically with fewer gates
and more explicit XOR structure — which is what the downstream
FBS-mapping quality (``nb_bootstrap``) depends on.
"""

from __future__ import annotations

from .bit_circuit import BitCircuit, BitNode, CONST0, CONST1

__all__ = ["optimize"]

# Literal encoding: lit = 2*idx + phase.  Node 0 is constant FALSE, so
# lit 0 = const0 and lit 1 = const1.
_FALSE, _TRUE = 0, 1


class _AIG:
    """Structurally hashed AND-inverter graph."""

    def __init__(self):
        # node 0 = const; others: ("in", name) | ("and", la, lb)
        self.nodes: list[tuple] = [("const",)]
        self._hash: dict[tuple[int, int], int] = {}

    def add_input(self, name: str) -> int:
        self.nodes.append(("in", name))
        return 2 * (len(self.nodes) - 1)

    def and_(self, la: int, lb: int) -> int:
        if la > lb:
            la, lb = lb, la
        if la == _FALSE or la == lb ^ 1:
            return _FALSE
        if la == _TRUE or la == lb:
            return lb
        idx = self._hash.get((la, lb))
        if idx is None:
            self.nodes.append(("and", la, lb))
            idx = len(self.nodes) - 1
            self._hash[(la, lb)] = idx
        return 2 * idx

    def or_(self, la: int, lb: int) -> int:
        return self.and_(la ^ 1, lb ^ 1) ^ 1

    def xor_(self, la: int, lb: int) -> int:
        # canonical strashed shape — the emitter's XOR matcher relies on it:
        # ¬(a∧b) ∧ ¬(¬a∧¬b) = ¬((a∧b) ∨ (¬a∧¬b)) = ¬XNOR = XOR
        return self.and_(self.and_(la, lb) ^ 1,
                         self.and_(la ^ 1, lb ^ 1) ^ 1)

    def mux_(self, ls: int, l1: int, l0: int) -> int:
        if l1 == l0:          # Shannon cofactors agree -> select is dead
            return l1
        if l1 == l0 ^ 1:      # f = s ? x : not x  ==  XNOR(s, x)... as XOR
            return self.xor_(ls, l0)
        return self.and_(self.and_(ls, l1) ^ 1,
                         self.and_(ls ^ 1, l0) ^ 1) ^ 1

    def from_table(self, fanins: list[int], table: tuple[int, ...]) -> int:
        """Synthesize an arbitrary (MSB-first) LUT over literal fanins."""
        if min(table) == max(table):
            return _TRUE if table[0] else _FALSE
        if len(fanins) == 1:
            return fanins[0] if table == (0, 1) else fanins[0] ^ 1
        if len(fanins) == 2:
            a, b = fanins
            t = tuple(table)
            if t == (0, 1, 1, 0):
                return self.xor_(a, b)
            if t == (1, 0, 0, 1):
                return self.xor_(a, b) ^ 1
            ones = [i for i, v in enumerate(t) if v]
            if len(ones) == 1:          # AND with input phases
                i = ones[0]
                return self.and_(a ^ (1 - (i >> 1)), b ^ (1 - (i & 1)))
            if len(ones) == 3:          # OR with input phases
                i = [i for i, v in enumerate(t) if not v][0]
                return self.and_(a ^ 1 ^ (i >> 1), b ^ 1 ^ (i & 1)) ^ 1
            # 2 ones, not XOR: depends on a single variable
            if t[0] == t[1] and t[2] == t[3]:
                return a if t[2] else a ^ 1
            assert t[0] == t[2] and t[1] == t[3]
            return b if t[1] else b ^ 1
        # n > 2: Shannon decomposition on the MSB variable
        half = len(table) // 2
        f0 = self.from_table(fanins[1:], table[:half])
        f1 = self.from_table(fanins[1:], table[half:])
        return self.mux_(fanins[0], f1, f0)


def _build_aig(circ: BitCircuit) -> tuple[_AIG, dict[int, int], dict[str, int]]:
    """Returns (aig, input-literal by circuit node id, output literals).

    Wires resolve by node identity (``nid``), matching ``BitCircuit.eval``
    — fanins reference exact node objects, and .bench wires named "0"/"1"
    must not collide with the constant singletons."""
    aig = _AIG()
    lit: dict[int, int] = {CONST0.nid: _FALSE, CONST1.nid: _TRUE}
    in_lits: dict[int, int] = {}
    # circ.inputs is the authoritative interface: remove_dangling_nodes()
    # may prune an unused input from circ.nodes while keeping it here, and
    # the emission loop below re-creates every interface input.
    for node in circ.inputs:
        l = aig.add_input(node.name)
        lit[node.nid] = l
        in_lits[node.nid] = l
    for node in circ.nodes:
        if node.kind == "input":
            if node.nid not in in_lits:  # input not in circ.inputs (defensive)
                l = aig.add_input(node.name)
                lit[node.nid] = l
                in_lits[node.nid] = l
        elif node.is_gate:
            fan = [lit[f.nid] for f in node.fanins]
            lit[node.nid] = aig.from_table(fan, node.table)
    outs = {name: lit[out.nid] for name, out in circ.outputs.items()}
    return aig, in_lits, outs


def optimize(circ: BitCircuit) -> BitCircuit:
    """strash + XOR recollapse + free-inverter LUT emission.

    Returns a new :class:`BitCircuit` with the same input/output names and
    identical cleartext semantics (asserted in tests/test_opt.py on
    random-vector oracles, mirroring the reference CLI's seed-42 check).
    """
    aig, in_lits, outs = _build_aig(circ)
    nodes = aig.nodes

    # reachable subgraph + exact fanout counts
    seen = [False] * len(nodes)
    stack = [l >> 1 for l in outs.values()]
    reach: list[int] = []
    while stack:
        idx = stack.pop()
        if seen[idx]:
            continue
        seen[idx] = True
        reach.append(idx)
        if nodes[idx][0] == "and":
            stack.extend(l >> 1 for l in nodes[idx][1:])
    refs = [0] * len(nodes)
    for idx in reach:
        if nodes[idx][0] == "and":
            for l in nodes[idx][1:]:
                refs[l >> 1] += 1
    for l in outs.values():
        refs[l >> 1] += 1

    def xor_match(la: int, lb: int):
        """n = AND(¬u, ¬v), u = AND(p, q), v = AND(¬p, ¬q) → n = p ⊕ q.

        Structural only — emitting n as one XOR gate is never worse than
        one AND gate; whether u/v die with it depends on their fanout."""
        if not (la & 1 and lb & 1):
            return None
        u, v = la >> 1, lb >> 1
        if nodes[u][0] != "and" or nodes[v][0] != "and":
            return None
        pu = (nodes[u][1], nodes[u][2])
        pv = (nodes[v][1] ^ 1, nodes[v][2] ^ 1)
        if pu != pv:  # children are kept (min,max)-sorted, so compare directly
            return None
        return pu  # n computes XOR of these two literal values

    out = BitCircuit()
    emitted: dict[int, BitNode] = {}
    for node in circ.inputs:  # preserve the full input interface + order
        in_node = out.add_input(node.name)
        emitted[in_lits[node.nid] >> 1] = in_node

    def base(l: int) -> BitNode:
        return emitted[l >> 1]

    # Top-down matching pass: decide XOR roots before emission so their
    # internal AND halves are never emitted.  Descending order resolves
    # nesting — if n is consumed as a half of a larger XOR, its own match
    # is void and its children stay live.  (A half's child can never
    # itself be skipped: it has ≥ 2 references by construction.)
    xor_of: dict[int, tuple[int, int]] = {}
    skip: set[int] = set()
    for idx in sorted(reach, reverse=True):
        nd = nodes[idx]
        if nd[0] != "and" or idx in skip:
            continue
        m = xor_match(nd[1], nd[2])
        if m is not None:
            xor_of[idx] = m
            # halves die only when this XOR was their sole consumer; shared
            # halves stay live for their other fanout (abc's area mapping
            # makes the same call: the XOR cell costs 1 either way)
            for half in (nd[1] >> 1, nd[2] >> 1):
                if refs[half] == 1:
                    skip.add(half)

    for idx in sorted(reach):  # ascending id = topological order
        nd = nodes[idx]
        if nd[0] != "and" or idx in skip:
            continue
        if idx in xor_of:
            lp, lq = xor_of[idx]
            ph = (lp & 1) ^ (lq & 1)      # node value = val_p ⊕ val_q
            table = tuple((x ^ y ^ ph) & 1 for x in (0, 1) for y in (0, 1))
            kind = "xor" if table == (0, 1, 1, 0) else "lut"
            emitted[idx] = out.lut([base(lp), base(lq)], table, kind=kind)
            continue
        la, lb = nd[1], nd[2]
        pa, pb = la & 1, lb & 1
        table = tuple(((x ^ pa) & (y ^ pb)) & 1
                      for x in (0, 1) for y in (0, 1))
        kind = "and" if table == (0, 0, 0, 1) else "lut"
        emitted[idx] = out.lut([base(la), base(lb)], table, kind=kind)

    for name, l in outs.items():
        if l == _FALSE:
            out.set_output(name, CONST0)
        elif l == _TRUE:
            out.set_output(name, CONST1)
        elif l & 1:
            out.set_output(name, out.not_(base(l)))
        else:
            out.set_output(name, base(l))
    # drop halves that became dead when a nested XOR root was itself
    # consumed by a larger match (rare; reachability handles it exactly)
    out.remove_dangling_nodes()
    return out
