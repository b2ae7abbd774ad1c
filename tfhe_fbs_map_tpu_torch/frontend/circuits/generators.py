"""Benchmark circuit generators.

The same benchmark family as the reference
(``experiments/generate_benchmarks.py:39-447``): small
arithmetic cells, the Ascon S-box layer, the Boyar–Peralta AES S-box middle
section, single-round and full-keystream Trivium/Kreyvium circuits, and the
complete 2-input gate set.  All are standard published circuits; each
generator returns a fresh :class:`BitCircuit`.
"""

from __future__ import annotations

from ..bit_circuit import BitCircuit
from .dsl import Bit, CircuitBuilder

__all__ = ["BENCH_GENERATORS", "EPFL_GENERATORS", "build_bench"]


def full_adder() -> BitCircuit:
    b = CircuitBuilder()
    a, x, c = b.input("a"), b.input("b"), b.input("cin")
    n1 = c ^ a
    n2 = c ^ x
    (n1 ^ x).output("out")
    ((n1 & n2) ^ c).output("cout")
    return b.circuit


def half_adder() -> BitCircuit:
    b = CircuitBuilder()
    a, x = b.input("a"), b.input("b")
    (a ^ x).output("out")
    (a & x).output("cout")
    return b.circuit


def ascon_lut() -> BitCircuit:
    """One 5-bit S-box column of the Ascon permutation (chi layer)."""
    b = CircuitBuilder()
    x0, x1, x2, x3, x4 = (b.input(f"x{k}") for k in range(5))
    x0 = x0 ^ x4
    x2 = x1 ^ x2
    x4 = x3 ^ x4
    t = [~x0 & x1, ~x1 & x2, ~x2 & x3, ~x3 & x4, ~x4 & x0]
    x0, x1, x2, x3, x4 = (x0 ^ t[1], x1 ^ t[2], x2 ^ t[3],
                          x3 ^ t[4], x4 ^ t[0])
    x1 = x0 ^ x1
    x3 = x2 ^ x3
    x0 = x0 ^ x4
    x2 = ~x2
    for k, x in enumerate((x0, x1, x2, x3, x4)):
        x.output(f"x{k}")
    return b.circuit


def aes_sbox() -> BitCircuit:
    """Boyar–Peralta AES S-box shared middle section (22 in / 18 out).

    The published minimal-multiplicative-complexity S-box circuit; inputs are
    the top-linear-layer outputs y1..y21, x7, outputs the z0..z17 feeding the
    bottom linear layer.
    """
    b = CircuitBuilder()
    y = {k: b.input(f"y{k}") for k in range(1, 22)}
    x7 = b.input("x7")

    t2 = y[12] & y[15]
    t3 = y[3] & y[6]
    t4 = t3 ^ t2
    t5 = y[4] & x7
    t6 = t5 ^ t2
    t7 = y[13] & y[16]
    t8 = y[5] & y[1]
    t9 = t8 ^ t7
    t10 = y[2] & y[7]
    t11 = t10 ^ t7
    t12 = y[9] & y[11]
    t13 = y[14] & y[17]
    t14 = t13 ^ t12
    t15 = y[8] & y[10]
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y[20]
    t22 = t18 ^ y[19]
    t23 = t19 ^ y[21]
    t24 = t20 ^ y[18]
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    outs = [
        t44 & y[15], t37 & y[6], t33 & x7, t43 & y[16], t40 & y[1],
        t29 & y[7], t42 & y[11], t45 & y[17], t41 & y[10], t44 & y[12],
        t37 & y[3], t33 & y[4], t43 & y[13], t40 & y[5], t29 & y[2],
        t42 & y[9], t45 & y[14], t41 & y[8],
    ]
    for k, z in enumerate(outs):
        z.output(f"z{k}")
    return b.circuit


def simon_iter() -> BitCircuit:
    b = CircuitBuilder()
    bits = [b.input(f"b{k}") for k in range(5)]
    ((bits[0] & bits[1]) ^ bits[2] ^ bits[3] ^ bits[4]).output("out")
    return b.circuit


def _2_input_gates() -> BitCircuit:
    b = CircuitBuilder()
    a, x = b.input("a"), b.input("b")
    (a & x).output("and")
    (~(a & x)).output("nand")
    (a & ~x).output("andyn")
    (~a & x).output("andnu")
    (a | x).output("or")
    (~(a | x)).output("nor")
    (a | ~x).output("oryn")
    (~a | x).output("ornu")
    (a ^ x).output("xor")
    (~(a ^ x)).output("xnor")
    return b.circuit


def aoi21() -> BitCircuit:
    b = CircuitBuilder()
    a, x, c = b.input("a"), b.input("b"), b.input("c")
    (~((a & x) | c)).output("out")
    return b.circuit


def oai21() -> BitCircuit:
    b = CircuitBuilder()
    a, x, c = b.input("a"), b.input("b"), b.input("c")
    (~((a | x) & c)).output("out")
    return b.circuit


# ---------------------------------------------------------------------------
# Trivium / Kreyvium stream ciphers.  The three `v*` variants differ only in
# the xor association order of the feedback taps, which changes the XAG the
# mapper sees (reference ``generate_benchmarks.py:240-357``).
# ---------------------------------------------------------------------------

_TAP_INDICES = [66, 162, 243, 91, 92, 93, 175, 176, 177,
                286, 287, 288, 69, 171, 264]


def _trivium_step(s, variant: int, k127: Bit | None = None,
                  iv127: Bit | None = None):
    t1 = s[66] ^ s[93]
    t2 = s[162] ^ s[177]
    t3 = s[243] ^ s[288]
    if k127 is not None:
        t3 = t3 ^ k127

    r = t1 ^ t2 ^ t3

    a1, a2, a3 = s[91] & s[92], s[175] & s[176], s[286] & s[287]
    if variant == 1:
        t1 = t1 ^ a1 ^ s[171]
        if iv127 is not None:
            t1 = t1 ^ iv127
        t2 = t2 ^ a2 ^ s[264]
        t3 = t3 ^ a3 ^ s[69]
    elif variant == 2:
        f1 = t1 ^ s[171]
        if iv127 is not None:
            f1 = f1 ^ iv127
        t1 = f1 ^ a1
        t2 = (t2 ^ s[264]) ^ a2
        t3 = (t3 ^ s[69]) ^ a3
    else:
        f1 = t1 ^ s[171]
        if iv127 is not None:
            f1 = f1 ^ iv127
        t1 = a1 ^ f1
        t2 = a2 ^ (t2 ^ s[264])
        t3 = a3 ^ (t3 ^ s[69])
    return r, t1, t2, t3


def _iter_bench(variant: int, kreyvium: bool) -> BitCircuit:
    b = CircuitBuilder()
    s = {k: b.input(f"s{k}") for k in _TAP_INDICES}
    k127 = b.input("k127") if kreyvium else None
    iv127 = b.input("IV127") if kreyvium else None
    r, t1, t2, t3 = _trivium_step(s, variant, k127, iv127)
    r.output("y")
    t1.output("t1")
    t2.output("t2")
    t3.output("t3")
    return b.circuit


def _stream_bench(variant: int, kreyvium: bool,
                  iters: int = 288 * 4) -> BitCircuit:
    b = CircuitBuilder()
    s = [None] + [b.input(f"s{k}") for k in range(1, 289)]
    if kreyvium:
        key = [b.input(f"K{k}") for k in range(128)]
        iv = [b.input(f"IV{k}") for k in range(128)]

    for i in range(iters):
        if kreyvium:
            r, t1, t2, t3 = _trivium_step(s, variant, key[127], iv[127])
        else:
            r, t1, t2, t3 = _trivium_step(s, variant)
        r.output(f"r{i}")
        s[1:94] = [t3, *s[1:93]]
        s[94:178] = [t1, *s[94:177]]
        s[178:289] = [t2, *s[178:288]]
        if kreyvium:
            key = [key[127], *key[:127]]
            iv = [iv[127], *iv[:127]]

    for i in range(1, 289):
        s[i].output()
    return b.circuit


def _state_bench(variant: int) -> BitCircuit:
    """Trivium 1152-round key schedule starting from key/IV/constants."""
    b = CircuitBuilder()
    s = [None]
    s += [b.input(f"K{k - 1}") for k in range(1, 81)]
    s += [b.const(0) for _ in range(81, 94)]
    s += [b.input(f"IV{k - 94}") for k in range(94, 174)]
    s += [b.const(0) for _ in range(174, 286)]
    s += [b.const(1) for _ in range(286, 289)]

    for _ in range(1152):
        r, t1, t2, t3 = _trivium_step(s, variant)
        s[1:94] = [t3, *s[1:93]]
        s[94:178] = [t1, *s[94:177]]
        s[178:289] = [t2, *s[178:288]]

    for i in range(1, 289):
        s[i].output(f"s{i}")
    return b.circuit


# ---------------------------------------------------------------------------
# EPFL-style arithmetic benchmarks (functional regenerations)
#
# The reference sweeps the EPFL combinational suite fetched over the network
# (``gen_makefile_epfl.bash:7``).  The original BLIF netlists cannot be
# vendored without egress, so the well-specified arithmetic members are
# regenerated from their functional definitions at the same scale (adder:
# 256 in / 129 out; bar: 135 in / 128 out; max: 512 in / 130 out).  Gate
# structure differs from the EPFL netlists (these are plain ripple/mux
# forms), so mapping-quality numbers are comparable in spirit, not
# gate-for-gate.
# ---------------------------------------------------------------------------

_EPFL_WIDTH = 128


def _ripple_add(b, xs, ys, cin=None):
    """Ripple-carry sum bits + carry-out (LSB-first lists)."""
    carry = cin
    out = []
    for a, y in zip(xs, ys):
        s = a ^ y
        if carry is None:
            out.append(s)
            carry = a & y
        else:
            out.append(s ^ carry)
            carry = (a & y) | (carry & (a ^ y))
    return out, carry


def epfl_adder(width: int = _EPFL_WIDTH) -> BitCircuit:
    b = CircuitBuilder()
    xs = [b.input(f"a{i}") for i in range(width)]
    ys = [b.input(f"b{i}") for i in range(width)]
    out, carry = _ripple_add(b, xs, ys)
    for i, s in enumerate(out):
        s.output(f"s{i}")
    carry.output(f"s{width}")
    return b.circuit


def _mux(s, a, x):
    """s ? a : x  (3 gates)."""
    return x ^ (s & (a ^ x))


def epfl_bar(width: int = _EPFL_WIDTH) -> BitCircuit:
    """Barrel shifter: rotate-left ``data`` by the 7-bit ``shift``."""
    b = CircuitBuilder()
    data = [b.input(f"d{i}") for i in range(width)]
    nbits = (width - 1).bit_length()
    shift = [b.input(f"s{j}") for j in range(nbits)]
    for j, sbit in enumerate(shift):
        amt = 1 << j
        data = [_mux(sbit, data[(i - amt) % width], data[i])
                for i in range(width)]
    for i, d in enumerate(data):
        d.output(f"o{i}")
    return b.circuit


def _greater(b, xs, ys):
    """xs > ys (unsigned, LSB-first lists): LSB-up ripple, so each higher
    bit's verdict overrides the accumulated lower-bit comparison."""
    gt = None
    for a, y in zip(xs, ys):
        here = a & ~y
        if gt is None:
            gt = here
        else:
            gt = here | (~(a ^ y) & gt)
    return gt


def epfl_max(width: int = _EPFL_WIDTH) -> BitCircuit:
    """Max of four ``width``-bit values + the 2-bit argmax index."""
    b = CircuitBuilder()
    vals = [[b.input(f"x{k}_{i}") for i in range(width)] for k in range(4)]

    def vmax(xs, ys):
        gt = _greater(b, xs, ys)
        return [_mux(gt, a, y) for a, y in zip(xs, ys)], gt

    m01, g01 = vmax(vals[0], vals[1])          # g01 = x0 > x1
    m23, g23 = vmax(vals[2], vals[3])
    m, gfin = vmax(m01, m23)                   # gfin = max01 > max23
    for i, v in enumerate(m):
        v.output(f"m{i}")
    # index: high bit = winner came from {x2, x3}; low bit = odd member won
    (~gfin).output("idx1")
    _mux(gfin, ~g01, ~g23).output("idx0")
    return b.circuit


def _csa_mult(b, xs, ys):
    """Carry-save array multiplier over DSL nodes (LSB-first lists)."""
    n, m = len(xs), len(ys)
    rows = [[xs[i] & ys[j] for i in range(n)] for j in range(m)]
    acc = rows[0]
    for j in range(1, m):
        shifted = acc[j:]
        new, c = [], None
        for i in range(n):
            x = rows[j][i]
            y = shifted[i] if i < len(shifted) else None
            if y is None and c is None:
                new.append(x)
            elif y is None:
                new.append(x ^ c)
                c = x & c
            elif c is None:
                new.append(x ^ y)
                c = x & y
            else:
                s1 = x ^ y
                new.append(s1 ^ c)
                c = (x & y) | (s1 & c)
        acc = acc[:j] + new + ([c] if c is not None else [])
    return acc[:n + m]


def epfl_multiplier(width: int = 64) -> BitCircuit:
    """EPFL ``multiplier``: 64x64 -> 128 (exact function, CSA-array form)."""
    b = CircuitBuilder()
    xs = [b.input(f"a{i}") for i in range(width)]
    ys = [b.input(f"b{i}") for i in range(width)]
    for i, p in enumerate(_csa_mult(b, xs, ys)):
        p.output(f"p{i}")
    return b.circuit


def epfl_square(width: int = 64) -> BitCircuit:
    """EPFL ``square``: x^2 of a 64-bit input (exact function)."""
    b = CircuitBuilder()
    xs = [b.input(f"a{i}") for i in range(width)]
    for i, p in enumerate(_csa_mult(b, xs, list(xs))):
        p.output(f"p{i}")
    return b.circuit


EPFL_GENERATORS = {
    "adder": epfl_adder,
    "bar": epfl_bar,
    "max": epfl_max,
    "multiplier": epfl_multiplier,
    "square": epfl_square,
}

# random_control class + div/sqrt (epfl_control.py regenerations)
from .epfl_control import EPFL_CONTROL_GENERATORS  # noqa: E402

EPFL_GENERATORS.update(EPFL_CONTROL_GENERATORS)


def _make_named(fn, *args, name):
    def gen():
        return fn(*args)
    gen.__name__ = name
    return gen


BENCH_GENERATORS = {
    "ascon_lut": ascon_lut,
    "aes_sbox": aes_sbox,
    "simon_iter": simon_iter,
    "_2_input_gates": _2_input_gates,
    "full_adder": full_adder,
    "half_adder": half_adder,
    "aoi21": aoi21,
    "oai21": oai21,
}
for _v in (1, 2, 3):
    BENCH_GENERATORS[f"trivium_iter_v{_v}"] = _make_named(
        _iter_bench, _v, False, name=f"trivium_iter_v{_v}")
    BENCH_GENERATORS[f"kreyvium_iter_v{_v}"] = _make_named(
        _iter_bench, _v, True, name=f"kreyvium_iter_v{_v}")
    BENCH_GENERATORS[f"trivium_stream_v{_v}"] = _make_named(
        _stream_bench, _v, False, name=f"trivium_stream_v{_v}")
    BENCH_GENERATORS[f"kreyvium_stream_v{_v}"] = _make_named(
        _stream_bench, _v, True, name=f"kreyvium_stream_v{_v}")
    BENCH_GENERATORS[f"trivium_state_v{_v}"] = _make_named(
        _state_bench, _v, name=f"trivium_state_v{_v}")


def build_bench(name: str) -> BitCircuit:
    circ = BENCH_GENERATORS[name]()
    circ.remove_dangling_nodes()
    return circ
