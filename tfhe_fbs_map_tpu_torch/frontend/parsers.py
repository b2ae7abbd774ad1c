"""Circuit format readers: BLIF, Bristol-fashion, and ISCAS ``.bench``.

Self-contained equivalents of the reference's parser adapters
(``fbs_mapper/map_circuit.py:12-89``), which wrap the
``blifparser`` and ``bfcl`` pip packages.  This module has no third-party
dependencies and additionally covers:

* don't-care (``-``) rows in BLIF covers (abc emits them for XAG netlists),
* the ISCAS ``.bench`` format directly, including multi-input gate
  decomposition into 2-input trees and sequential-circuit unrolling — the
  role the reference delegates to the external ``abc`` binary
  (``experiments/gen_makefile_iscas85.bash:41``,
  ``experiments/gen_makefile_iscas89.bash:83``).
"""

from __future__ import annotations

import re

from .bit_circuit import BitCircuit, BitNode, CONST0, CONST1

__all__ = ["parse_blif", "parse_bristol", "parse_bench", "parse_circuit"]


# ---------------------------------------------------------------------------
# BLIF
# ---------------------------------------------------------------------------

def _blif_statements(text: str):
    """Logical lines: comments stripped, ``\\`` continuations joined."""
    logical: list[str] = []
    pending = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if line.endswith("\\"):
            pending += line[:-1] + " "
            continue
        logical.append(pending + line)
        pending = ""
    if pending.strip():
        logical.append(pending)
    return logical


def _cover_to_table(rows: list[tuple[str, str]], n: int) -> list[int]:
    """Dense truth table from BLIF cover rows (with ``-`` expansion).

    All rows of one stanza share an output polarity ``v``; unlisted input
    patterns get ``1 - v`` (reference ``map_circuit.py:12-22``).
    """
    if not rows:
        return [0]  # empty cover = constant 0
    val = int(rows[0][1])
    table = [1 - val] * (1 << n)

    def fill(pattern: str, pos: int, idx: int):
        if pos == len(pattern):
            table[idx] = val
            return
        ch = pattern[pos]
        if ch == "-":
            fill(pattern, pos + 1, idx << 1)
            fill(pattern, pos + 1, (idx << 1) | 1)
        else:
            fill(pattern, pos + 1, (idx << 1) | int(ch))

    for pattern, out in rows:
        assert int(out) == val, "mixed-polarity BLIF cover"
        assert len(pattern) == n, "cover row arity mismatch"
        fill(pattern, 0, 0)
    return table


def parse_blif(text_or_path: str, max_fanin: int | None = 2) -> BitCircuit:
    """Parse a BLIF netlist into a :class:`BitCircuit`.

    ``max_fanin`` asserts the gate arity bound the mappers support
    (reference accepts only 1- and 2-input gates, ``map_circuit.py:43``);
    pass ``None`` to allow arbitrary LUTs.
    """
    text = _read(text_or_path)
    stmts = _blif_statements(text)

    inputs: list[str] = []
    outputs: list[str] = []
    stanzas: list[tuple[list[str], list[tuple[str, str]]]] = []

    i = 0
    while i < len(stmts):
        parts = stmts[i].split()
        key = parts[0]
        if key == ".model":
            i += 1
        elif key == ".inputs":
            inputs.extend(parts[1:])
            i += 1
        elif key == ".outputs":
            outputs.extend(parts[1:])
            i += 1
        elif key == ".names":
            sig = parts[1:]
            rows: list[tuple[str, str]] = []
            i += 1
            while i < len(stmts) and not stmts[i].startswith("."):
                row = stmts[i].split()
                if len(row) == 1:  # constant single-output row
                    rows.append(("", row[0]))
                else:
                    rows.append((row[0], row[1]))
                i += 1
            stanzas.append((sig, rows))
        elif key in (".end", ".exdc"):
            i += 1
        elif key in (".latch",):
            raise ValueError("BLIF latches are not supported; unroll first")
        else:  # ignore unknown dot-directives
            i += 1

    circ = BitCircuit()
    wires: dict[str, BitNode] = {name: circ.add_input(name)
                                 for name in inputs}

    for sig, rows in stanzas:
        *fanin_names, out_name = sig
        table = _cover_to_table(rows, len(fanin_names))
        if max(table) == 0:
            wires[out_name] = CONST0
        elif min(table) == 1:
            wires[out_name] = CONST1
        else:
            if max_fanin is not None:
                assert len(fanin_names) <= max_fanin, (
                    f"gate {out_name} has fan-in {len(fanin_names)} > "
                    f"{max_fanin}")
            fanins = [wires[n] for n in fanin_names]
            wires[out_name] = circ.lut(fanins, table, name=out_name)

    for name in outputs:
        circ.set_output(name, wires[name])
    return circ


# ---------------------------------------------------------------------------
# Bristol fashion  (https://nigelsmart.github.io/MPC-Circuits/)
# ---------------------------------------------------------------------------

_BRISTOL_OPS = {
    "AND": (0, 0, 0, 1),
    "XOR": (0, 1, 1, 0),
    "OR": (0, 1, 1, 1),
    "NAND": (1, 1, 1, 0),
    "NOR": (1, 0, 0, 0),
    "XNOR": (1, 0, 0, 1),
    "INV": (1, 0),
    "NOT": (1, 0),
}


def parse_bristol(text_or_path: str) -> BitCircuit:
    """Parse a Bristol-fashion circuit.

    Wire naming matches the reference adapter (``map_circuit.py:53-89``):
    inputs are ``i_<wire>``, gate outputs ``w_<wire>``, output names are the
    output wire indices.
    """
    text = _read(text_or_path)
    lines = [ln.split() for ln in text.splitlines() if ln.strip()]

    n_gates, _n_wires = int(lines[0][0]), int(lines[0][1])
    in_spec = [int(x) for x in lines[1][1:]]
    out_spec = [int(x) for x in lines[2][1:]]
    n_in_wires = sum(in_spec)
    n_out_wires = sum(out_spec)

    circ = BitCircuit()
    wires: dict[int, BitNode] = {
        w: circ.add_input(f"i_{w}") for w in range(n_in_wires)}

    gate_lines = lines[3:3 + n_gates]
    total_wires = _n_wires
    for parts in gate_lines:
        n_in, n_out = int(parts[0]), int(parts[1])
        ins = [int(x) for x in parts[2:2 + n_in]]
        outs = [int(x) for x in parts[2 + n_in:2 + n_in + n_out]]
        op = parts[2 + n_in + n_out]
        assert n_out == 1, "multi-output Bristol gates unsupported"
        out = outs[0]
        if op in ("EQW",):  # wire copy
            wires[out] = wires[ins[0]]
        elif op == "EQ":  # constant assignment: input is the literal 0/1
            wires[out] = CONST1 if ins[0] else CONST0
        else:
            table = _BRISTOL_OPS.get(op)
            assert table is not None, f"unknown Bristol op {op}"
            assert len(table) == 1 << n_in, f"op {op} arity mismatch"
            fanins = [wires[w] for w in ins]
            wires[out] = circ.lut(fanins, table, name=f"w_{out}")

    out_wires = range(total_wires - n_out_wires, total_wires)
    for w in out_wires:
        circ.set_output(str(w), wires[w])
    return circ


# ---------------------------------------------------------------------------
# ISCAS .bench
# ---------------------------------------------------------------------------

_BENCH_RE = re.compile(r"^\s*(\S+)\s*=\s*([A-Za-z]+)\s*\(([^)]*)\)\s*$")


def _tree_reduce(circ: BitCircuit, op, nodes: list[BitNode]) -> BitNode:
    """Balanced binary tree over a 2-input builder (multi-input gates)."""
    while len(nodes) > 1:
        nxt = []
        for i in range(0, len(nodes) - 1, 2):
            nxt.append(op(nodes[i], nodes[i + 1]))
        if len(nodes) % 2:
            nxt.append(nodes[-1])
        nodes = nxt
    return nodes[0]


def parse_bench(text_or_path: str, unroll_frames: int = 1,
                init_state: int = 0) -> BitCircuit:
    """Parse an ISCAS ``.bench`` netlist.

    Combinational circuits (ISCAS85) parse directly; multi-input AND/OR/...
    gates are decomposed into balanced 2-input trees (the role abc's genlib
    XAG mapping plays in the reference pipeline).

    Sequential circuits (ISCAS89, ``DFF`` gates) are unrolled over
    ``unroll_frames`` time frames with flip-flops initialized to
    ``init_state`` — the equivalent of the reference's
    ``abc frames -F 10 -i`` preprocessing
    (``gen_makefile_iscas89.bash:83``).  Per frame ``t``, inputs are suffixed
    ``_f{t}`` and outputs ``_f{t}`` (single-frame circuits keep bare names).
    """
    text = _read(text_or_path)
    inputs: list[str] = []
    outputs: list[str] = []
    gates: list[tuple[str, str, list[str]]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        up = line.upper()
        if up.startswith("INPUT("):
            inputs.append(line[line.index("(") + 1:line.rindex(")")].strip())
        elif up.startswith("OUTPUT("):
            outputs.append(line[line.index("(") + 1:line.rindex(")")].strip())
        else:
            m = _BENCH_RE.match(line)
            assert m, f"unparseable .bench line: {line!r}"
            out, op, args = m.group(1), m.group(2).upper(), m.group(3)
            fanins = [a.strip() for a in args.split(",") if a.strip()]
            gates.append((out, op, fanins))

    dffs = [(out, fanins[0]) for out, op, fanins in gates if op == "DFF"]
    comb = [(out, op, fanins) for out, op, fanins in gates if op != "DFF"]

    circ = BitCircuit()
    frames = unroll_frames if dffs else 1
    # state wires feeding frame 0 hold the initial value
    state: dict[str, BitNode] = {
        out: (CONST1 if init_state else CONST0) for out, _ in dffs}

    def build(circ, op, fanins, name):
        if op == "AND":
            return _tree_reduce(circ, circ.and_, fanins)
        if op == "OR":
            return _tree_reduce(circ, circ.or_, fanins)
        if op == "XOR":
            return _tree_reduce(circ, circ.xor_, fanins)
        if op == "NAND":
            return circ.not_(_tree_reduce(circ, circ.and_, fanins))
        if op == "NOR":
            return circ.not_(_tree_reduce(circ, circ.or_, fanins))
        if op == "XNOR":
            return circ.not_(_tree_reduce(circ, circ.xor_, fanins))
        if op in ("NOT", "INV"):
            assert len(fanins) == 1
            return circ.not_(fanins[0])
        if op in ("BUF", "BUFF"):
            assert len(fanins) == 1
            return fanins[0]
        raise ValueError(f"unknown .bench op {op}")

    for t in range(frames):
        sfx = f"_f{t}" if frames > 1 else ""
        wires: dict[str, BitNode] = dict(state)
        for name in inputs:
            wires[name] = circ.add_input(name + sfx)

        # gates may be listed out of order in .bench files: iterate to fixpoint
        pending = list(comb)
        while pending:
            remaining = []
            progressed = False
            for out, op, fanins in pending:
                if all(f in wires for f in fanins):
                    wires[out] = build(circ, op, [wires[f] for f in fanins],
                                       out + sfx)
                    progressed = True
                else:
                    remaining.append((out, op, fanins))
            assert progressed or not remaining, (
                f"combinational loop or undefined wires: "
                f"{[g[0] for g in remaining][:5]}")
            pending = remaining

        for name in outputs:
            circ.set_output(name + sfx, wires[name])
        state = {out: wires[src] for out, src in dffs}

    return circ


# ---------------------------------------------------------------------------

def _read(text_or_path: str) -> str:
    if "\n" in text_or_path or text_or_path.lstrip().startswith("."):
        return text_or_path
    with open(text_or_path) as f:
        return f.read()


def parse_circuit(path: str, fmt: str = "blif", **kw) -> BitCircuit:
    if fmt == "blif":
        return parse_blif(path, **kw)
    if fmt == "bristol":
        return parse_bristol(path, **kw)
    if fmt == "bench":
        return parse_bench(path, **kw)
    raise ValueError(f"unknown circuit format {fmt!r}")
