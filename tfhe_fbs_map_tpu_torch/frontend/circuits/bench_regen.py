"""Regenerated ISCAS85/89-class benchmark netlists (verified .bench files).

The reference sweeps the ISCAS85/ISCAS89 suites
(``experiments/gen_makefile_iscas85.bash:7-41``,
``gen_makefile_iscas89.bash:7-43``).  The canonical netlists are public
text files; rather than download them we REGENERATE
functional equivalents from each benchmark's published functional
specification (Hansen/Yalcin/Hayes, "Unveiling the ISCAS-85 benchmarks");
each generated netlist is verified against a cleartext golden model on
random vectors before it is written.

Provenance is explicit: files carry an ``r`` suffix (c6288r, s344r, ...)
and a header comment.  Where the original function is fully determined
(c6288 = 16x16 array multiplier, c499/c1355 = 32-bit single-error
corrector, c880 = dual-74181 ALU slice), the regeneration computes the
same function in the same size class; for control-dominated originals the
regeneration implements the documented architecture (channel counts, data
widths, state-bit counts) with a precisely specified behavior of our own,
so mapping-cost comparisons against published per-circuit numbers are
size-class comparisons, marked "(regen)" by experiments/analyse.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BenchBuilder", "REGEN85", "REGEN89", "emit_all", "verify_circuit"]


class BenchBuilder:
    """Tiny .bench netlist builder (2-input gates + DFF + NOT)."""

    def __init__(self):
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self.gates: list[tuple[str, str, list[str]]] = []
        self._n = 0

    def inp(self, name: str) -> str:
        self.inputs.append(name)
        return name

    def inps(self, prefix: str, n: int) -> list[str]:
        return [self.inp(f"{prefix}{i}") for i in range(n)]

    def out(self, name: str) -> None:
        self.outputs.append(name)

    def _g(self, op: str, *fanins: str) -> str:
        self._n += 1
        name = f"n{self._n}"
        self.gates.append((name, op, list(fanins)))
        return name

    def and_(self, a, b):
        return self._g("AND", a, b)

    def or_(self, a, b):
        return self._g("OR", a, b)

    def xor(self, a, b):
        return self._g("XOR", a, b)

    def nand(self, a, b):
        return self._g("NAND", a, b)

    def nor(self, a, b):
        return self._g("NOR", a, b)

    def not_(self, a):
        return self._g("NOT", a)

    def dff(self, d: str) -> str:
        self._n += 1
        name = f"s{self._n}"
        self.gates.append((name, "DFF", [d]))
        return name

    def mux(self, s, a, b):
        """s ? b : a"""
        return self.or_(self.and_(self.not_(s), a), self.and_(s, b))

    def tree(self, op, xs):
        xs = list(xs)
        while len(xs) > 1:
            nxt = [op(xs[i], xs[i + 1]) for i in range(0, len(xs) - 1, 2)]
            if len(xs) % 2:
                nxt.append(xs[-1])
            xs = nxt
        return xs[0]

    def serialize(self, header: str = "") -> str:
        lines = [f"# {ln}" for ln in header.splitlines() if ln]
        lines += [f"INPUT({i})" for i in self.inputs]
        lines += [f"OUTPUT({o})" for o in self.outputs]
        # DFF declarations first (ISCAS89 convention), then logic
        for name, op, fan in self.gates:
            if op == "DFF":
                lines.append(f"{name} = DFF({fan[0]})")
        for name, op, fan in self.gates:
            if op != "DFF":
                lines.append(f"{name} = {op}({', '.join(fan)})")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Shared arithmetic blocks
# ---------------------------------------------------------------------------

def full_adder(b, x, y, c):
    s1 = b.xor(x, y)
    return b.xor(s1, c), b.or_(b.and_(x, y), b.and_(s1, c))


def ripple_add(b, xs, ys, cin):
    """LSB-first ripple adder; returns (sum bits, carry-out)."""
    c, out = cin, []
    for x, y in zip(xs, ys):
        s, c = full_adder(b, x, y, c)
        out.append(s)
    return out, c


def csa_multiplier(b, xs, ys):
    """Array multiplier, LSB-first operands; returns len(xs)+len(ys) bits."""
    n, m = len(xs), len(ys)
    rows = [[b.and_(xs[i], ys[j]) for i in range(n)] for j in range(m)]
    acc = rows[0]
    carry = None
    for j in range(1, m):
        shifted = acc[j:]           # align: row j starts at bit j
        row = rows[j]
        new, c = [], None
        for i in range(n):
            x = row[i]
            y = shifted[i] if i < len(shifted) else None
            if y is None and c is None:
                new.append(x)
            elif y is None:
                s, c = full_adder_opt(b, x, c)
                new.append(s)
            elif c is None:
                s = b.xor(x, y)
                c = b.and_(x, y)
                new.append(s)
            else:
                s, c = full_adder(b, x, y, c)
                new.append(s)
        acc = acc[:j] + new + ([c] if c is not None else [])
        carry = None
    del carry
    return acc[:n + m]


def full_adder_opt(b, x, c):
    return b.xor(x, c), b.and_(x, c)


# ---------------------------------------------------------------------------
# ISCAS85-class generators (combinational)
# ---------------------------------------------------------------------------

def gen_c432r():
    """27-channel interrupt controller (c432 architecture: 3 buses x 9
    channels + 9 enables; grants the highest-priority active bus and
    reports which channels of the granted bus are serviced)."""
    b = BenchBuilder()
    A, B_, C, E = (b.inps(p, 9) for p in "ABCE")
    a_req = [b.and_(A[i], E[i]) for i in range(9)]
    b_req = [b.and_(B_[i], E[i]) for i in range(9)]
    c_req = [b.and_(C[i], E[i]) for i in range(9)]
    pa = b.tree(b.or_, a_req)
    pb_raw = b.tree(b.or_, b_req)
    pc_raw = b.tree(b.or_, c_req)
    pb = b.and_(b.not_(pa), pb_raw)
    pc = b.and_(b.not_(pa), b.and_(b.not_(pb_raw), pc_raw))
    # serviced channel lines of the granted bus (9-bit one-hot-ish bus)
    chan = [b.or_(b.and_(pa, a_req[i]),
                  b.or_(b.and_(pb, b_req[i]), b.and_(pc, c_req[i])))
            for i in range(9)]
    # encode the highest-index serviced channel in 4 bits
    enc = []
    for bit in range(4):
        terms = []
        for i in range(9):
            if (i >> bit) & 1:
                higher = [chan[j] for j in range(i + 1, 9)]
                sel = chan[i]
                for h in higher:
                    sel = b.and_(sel, b.not_(h))
                terms.append(sel)
        enc.append(b.tree(b.or_, terms) if terms else b.and_(
            chan[0], b.not_(chan[0])))
    for name, sig in zip(("PA", "PB", "PC"), (pa, pb, pc)):
        b.gates.append((name, "BUFF", [sig]))
        b.out(name)
    for k in range(4):
        b.gates.append((f"AD{k}", "BUFF", [enc[k]]))
        b.out(f"AD{k}")
    return b


def golden_c432r(v):
    A, B_, C, E = (np.stack([v[f"{p}{i}"] for i in range(9)]) for p in "ABCE")
    ar, br, cr = A & E, B_ & E, C & E
    pa = ar.any(0).astype(int)
    pb = (1 - pa) & br.any(0).astype(int)
    pc = (1 - pa) & (1 - br.any(0).astype(int)) & cr.any(0).astype(int)
    chan = pa * ar + pb * br + pc * cr
    idx = np.where(chan.any(0), 8 - np.argmax(chan[::-1], axis=0), 0)
    out = {"PA": pa, "PB": pb, "PC": pc}
    for k in range(4):
        out[f"AD{k}"] = (idx >> k) & 1
    return out


_SEC_COLS32 = [c for c in range(1, 256)
               if bin(c).count("1") % 2 == 1 and c not in (1, 2, 4, 8, 16,
                                                           32, 64, 128)][:32]


def gen_c499r(expand_xor: bool = False):
    """32-bit single-error-correcting circuit (c499/c1355 function class):
    8 syndrome bits over a (40,32) odd-weight-column code; a matching
    syndrome flips the corresponding data bit.  c1355r is the same netlist
    with every XOR expanded into 4 NANDs (the documented relation between
    c499 and c1355)."""
    b = BenchBuilder()
    if expand_xor:
        def xor(x, y):
            n1 = b.nand(x, y)
            return b.nand(b.nand(x, n1), b.nand(y, n1))
    else:
        xor = b.xor
    D = b.inps("ID", 32)
    Cb = b.inps("IC", 8)
    syn = []
    for k in range(8):
        grp = [D[i] for i in range(32) if (_SEC_COLS32[i] >> k) & 1]
        syn.append(b.tree(xor, grp + [Cb[k]]))
    for i in range(32):
        col = _SEC_COLS32[i]
        lits = [syn[k] if (col >> k) & 1 else b.not_(syn[k])
                for k in range(8)]
        match = b.tree(b.and_, lits)
        o = xor(D[i], match)
        b.gates.append((f"OD{i}", "BUFF", [o]))
        b.out(f"OD{i}")
    return b


def golden_c499r(v):
    D = np.stack([v[f"ID{i}"] for i in range(32)])
    Cb = np.stack([v[f"IC{k}"] for k in range(8)])
    syn = np.zeros_like(Cb)
    for k in range(8):
        acc = Cb[k].copy()
        for i in range(32):
            if (_SEC_COLS32[i] >> k) & 1:
                acc ^= D[i]
        syn[k] = acc
    out = {}
    for i in range(32):
        col = _SEC_COLS32[i]
        match = np.ones_like(D[0])
        for k in range(8):
            match &= syn[k] if (col >> k) & 1 else 1 - syn[k]
        out[f"OD{i}"] = D[i] ^ match
    return out


def gen_c880r():
    """8-bit ALU in the c880 architecture class: two cascaded 74181 slices
    (active-high), 4-bit function select + mode + carry-in, plus parity and
    A==B outputs."""
    b = BenchBuilder()
    A = b.inps("A", 8)
    Bi = b.inps("B", 8)
    S = b.inps("S", 4)
    M = b.inp("M")
    CIN = b.inp("CIN")

    def slice181(a, bb, cin):
        f_bits, c = [], cin
        # X = A | (S0&B) | (S1&~B); Y = (S2&A&~B) | (S3&A&B)
        for i in range(4):
            nb = b.not_(bb[i])
            x = b.or_(a[i], b.or_(b.and_(S[0], bb[i]), b.and_(S[1], nb)))
            y = b.or_(b.and_(S[2], b.and_(a[i], nb)),
                      b.and_(S[3], b.and_(a[i], bb[i])))
            ny = b.not_(y)
            # arithmetic (M=0): ripple F = X + ~Y + c; logic (M=1): F = X^Y
            s_ar, c_next = full_adder(b, x, ny, c)
            half = b.xor(x, y)
            f = b.mux(M, s_ar, half)
            c = c_next
            f_bits.append(f)
        return f_bits, c

    f_lo, c_mid = slice181(A[:4], Bi[:4], CIN)
    f_hi, cout = slice181(A[4:], Bi[4:], c_mid)
    F = f_lo + f_hi
    for i in range(8):
        b.gates.append((f"F{i}", "BUFF", [F[i]]))
        b.out(f"F{i}")
    b.gates.append(("COUT", "BUFF", [cout]))
    b.out("COUT")
    par = b.tree(b.xor, F)
    b.gates.append(("PAR", "BUFF", [par]))
    b.out("PAR")
    eq = b.tree(b.and_, [b.not_(b.xor(A[i], Bi[i])) for i in range(8)])
    b.gates.append(("AEQB", "BUFF", [eq]))
    b.out("AEQB")
    return b


def golden_c880r(v):
    A = sum(v[f"A{i}"].astype(np.int64) << i for i in range(8))
    Bv = sum(v[f"B{i}"].astype(np.int64) << i for i in range(8))
    out = {}
    f = np.zeros_like(A)
    c = v["CIN"].astype(np.int64)
    for half in range(2):
        a4 = (A >> (4 * half)) & 15
        b4 = (Bv >> (4 * half)) & 15
        nb = ~b4 & 15
        x = a4 | np.where(v["S0"] == 1, b4, 0) | np.where(v["S1"] == 1, nb, 0)
        y = (np.where(v["S2"] == 1, a4 & nb, 0)
             | np.where(v["S3"] == 1, a4 & b4, 0))
        t = x + (~y & 15) + c
        fh = np.where(v["M"] == 1, x ^ y, t & 15)
        c = (t >> 4) & 1          # the carry chain ripples in both modes
        f |= fh << (4 * half)
    for i in range(8):
        out[f"F{i}"] = (f >> i) & 1
    out["COUT"] = c & 1
    out["PAR"] = sum((f >> i) & 1 for i in range(8)) % 2
    out["AEQB"] = (A == Bv).astype(int)
    return out


_SECDED_COLS16 = [c for c in range(1, 64)
                  if bin(c).count("1") % 2 == 1][:16]


def gen_c1908r():
    """16-bit SEC/DED (c1908 function class): 6 syndrome bits + overall
    parity; corrects single errors, flags double errors."""
    b = BenchBuilder()
    D = b.inps("ID", 16)
    Cb = b.inps("IC", 6)
    P = b.inp("IP")
    syn = []
    for k in range(6):
        grp = [D[i] for i in range(16) if (_SECDED_COLS16[i] >> k) & 1]
        syn.append(b.tree(b.xor, grp + [Cb[k]]))
    overall = b.tree(b.xor, D + Cb + [P])
    syn_nz = b.tree(b.or_, syn)
    ded = b.and_(syn_nz, b.not_(overall))
    for i in range(16):
        col = _SECDED_COLS16[i]
        lits = [syn[k] if (col >> k) & 1 else b.not_(syn[k])
                for k in range(6)]
        match = b.and_(b.tree(b.and_, lits), overall)
        o = b.xor(D[i], match)
        b.gates.append((f"OD{i}", "BUFF", [o]))
        b.out(f"OD{i}")
    b.gates.append(("DED", "BUFF", [ded]))
    b.out("DED")
    return b


def golden_c1908r(v):
    D = np.stack([v[f"ID{i}"] for i in range(16)])
    Cb = np.stack([v[f"IC{k}"] for k in range(6)])
    P = v["IP"]
    syn = []
    for k in range(6):
        acc = Cb[k].copy()
        for i in range(16):
            if (_SECDED_COLS16[i] >> k) & 1:
                acc ^= D[i]
        syn.append(acc)
    syn = np.stack(syn)
    overall = (D.sum(0) + Cb.sum(0) + P) % 2
    out = {"DED": (syn.any(0) & (overall == 0)).astype(int)}
    for i in range(16):
        col = _SECDED_COLS16[i]
        match = np.ones_like(P)
        for k in range(6):
            match &= syn[k] if (col >> k) & 1 else 1 - syn[k]
        out[f"OD{i}"] = D[i] ^ (match & overall)
    return out


def gen_c2670r():
    """12-bit ALU + comparator class (c2670): 12-bit add, equality,
    magnitude compare, and a priority line over the sum."""
    b = BenchBuilder()
    A = b.inps("A", 12)
    Bi = b.inps("B", 12)
    CIN = b.inp("CIN")
    S, cout = ripple_add(b, A, Bi, CIN)
    for i in range(12):
        b.gates.append((f"S{i}", "BUFF", [S[i]]))
        b.out(f"S{i}")
    b.gates.append(("COUT", "BUFF", [cout]))
    b.out("COUT")
    eq = b.tree(b.and_, [b.not_(b.xor(A[i], Bi[i])) for i in range(12)])
    b.gates.append(("AEQB", "BUFF", [eq]))
    b.out("AEQB")
    # A < B via subtract: A + ~B + 1, borrow = NOT carry
    nB = [b.not_(x) for x in Bi]
    one = b.or_(A[0], b.not_(A[0]))
    _, c2 = ripple_add(b, A, nB, one)
    lt = b.not_(c2)
    b.gates.append(("ALTB", "BUFF", [lt]))
    b.out("ALTB")
    # priority: index of highest set sum bit, 4-bit encode
    enc = []
    for bit in range(4):
        terms = []
        for i in range(12):
            if (i >> bit) & 1:
                sel = S[i]
                for j in range(i + 1, 12):
                    sel = b.and_(sel, b.not_(S[j]))
                terms.append(sel)
        enc.append(b.tree(b.or_, terms))
    for k in range(4):
        b.gates.append((f"PR{k}", "BUFF", [enc[k]]))
        b.out(f"PR{k}")
    return b


def golden_c2670r(v):
    A = sum(v[f"A{i}"].astype(np.int64) << i for i in range(12))
    Bv = sum(v[f"B{i}"].astype(np.int64) << i for i in range(12))
    t = A + Bv + v["CIN"]
    out = {f"S{i}": (t >> i) & 1 for i in range(12)}
    out["COUT"] = (t >> 12) & 1
    out["AEQB"] = (A == Bv).astype(int)
    out["ALTB"] = (A < Bv).astype(int)
    s12 = t & 0xFFF
    idx = np.zeros_like(A)
    for i in range(12):
        idx = np.where((s12 >> i) & 1, i, idx)
    for k in range(4):
        out[f"PR{k}"] = (idx >> k) & 1
    return out


def gen_c3540r():
    """8-bit ALU with shifter (c3540 class): ops add/sub/and/or/xor/shl
    selected by 3 control bits, with zero & overflow flags."""
    b = BenchBuilder()
    A = b.inps("A", 8)
    Bi = b.inps("B", 8)
    OP = b.inps("OP", 3)
    nB = [b.not_(x) for x in Bi]
    zero = b.and_(A[0], b.not_(A[0]))
    one = b.not_(zero)
    add_s, add_c = ripple_add(b, A, Bi, zero)
    sub_s, sub_c = ripple_add(b, A, nB, one)
    and_b = [b.and_(A[i], Bi[i]) for i in range(8)]
    or_b = [b.or_(A[i], Bi[i]) for i in range(8)]
    xor_b = [b.xor(A[i], Bi[i]) for i in range(8)]
    shl_b = [zero] + A[:7]
    res = []
    for i in range(8):
        m01 = b.mux(OP[0], add_s[i], sub_s[i])
        m23 = b.mux(OP[0], and_b[i], or_b[i])
        m45 = b.mux(OP[0], xor_b[i], shl_b[i])
        m03 = b.mux(OP[1], m01, m23)
        m47 = b.mux(OP[1], m45, m45)
        res.append(b.mux(OP[2], m03, m47))
    for i in range(8):
        b.gates.append((f"R{i}", "BUFF", [res[i]]))
        b.out(f"R{i}")
    z = b.not_(b.tree(b.or_, res))
    b.gates.append(("Z", "BUFF", [z]))
    b.out("Z")
    cflag = b.mux(OP[0], add_c, sub_c)
    b.gates.append(("CF", "BUFF", [cflag]))
    b.out("CF")
    return b


def golden_c3540r(v):
    A = sum(v[f"A{i}"].astype(np.int64) << i for i in range(8))
    Bv = sum(v[f"B{i}"].astype(np.int64) << i for i in range(8))
    op = v["OP0"] + 2 * v["OP1"] + 4 * v["OP2"]
    add = A + Bv
    sub = A + ((~Bv) & 255) + 1
    cands = [add & 255, sub & 255, A & Bv, A | Bv, A ^ Bv, (A << 1) & 255,
             A ^ Bv, (A << 1) & 255]
    res = np.choose(op, cands)
    out = {f"R{i}": (res >> i) & 1 for i in range(8)}
    out["Z"] = (res == 0).astype(int)
    out["CF"] = np.where(v["OP0"] == 1, (sub >> 8) & 1, (add >> 8) & 1)
    return out


def gen_c6288r():
    """16x16 array multiplier — the exact c6288 function (32-bit product),
    built as the same carry-save adder array in AND/XOR/OR form."""
    b = BenchBuilder()
    X = b.inps("X", 16)
    Y = b.inps("Y", 16)
    P = csa_multiplier(b, X, Y)
    for i in range(32):
        b.gates.append((f"P{i}", "BUFF", [P[i]]))
        b.out(f"P{i}")
    return b


def golden_c6288r(v):
    X = sum(v[f"X{i}"].astype(np.int64) << i for i in range(16))
    Y = sum(v[f"Y{i}"].astype(np.int64) << i for i in range(16))
    p = X * Y
    return {f"P{i}": (p >> i) & 1 for i in range(32)}


def gen_c7552r():
    """34-bit adder/comparator class (c7552): 32-bit add with carry in/out,
    equality + magnitude compare, and byte parities."""
    b = BenchBuilder()
    A = b.inps("A", 32)
    Bi = b.inps("B", 32)
    CIN = b.inp("CIN")
    S, cout = ripple_add(b, A, Bi, CIN)
    for i in range(32):
        b.gates.append((f"S{i}", "BUFF", [S[i]]))
        b.out(f"S{i}")
    b.gates.append(("COUT", "BUFF", [cout]))
    b.out("COUT")
    eq = b.tree(b.and_, [b.not_(b.xor(A[i], Bi[i])) for i in range(32)])
    b.gates.append(("AEQB", "BUFF", [eq]))
    b.out("AEQB")
    nB = [b.not_(x) for x in Bi]
    one = b.not_(b.and_(A[0], b.not_(A[0])))
    _, c2 = ripple_add(b, A, nB, one)
    lt = b.not_(c2)
    b.gates.append(("ALTB", "BUFF", [lt]))
    b.out("ALTB")
    for k in range(4):
        par = b.tree(b.xor, S[8 * k:8 * k + 8])
        b.gates.append((f"PY{k}", "BUFF", [par]))
        b.out(f"PY{k}")
    return b


def golden_c7552r(v):
    A = sum(v[f"A{i}"].astype(np.int64) << i for i in range(32))
    Bv = sum(v[f"B{i}"].astype(np.int64) << i for i in range(32))
    t = A + Bv + v["CIN"]
    out = {f"S{i}": (t >> i) & 1 for i in range(32)}
    out["COUT"] = (t >> 32) & 1
    out["AEQB"] = (A == Bv).astype(int)
    out["ALTB"] = (A < Bv).astype(int)
    s = t & 0xFFFFFFFF
    for k in range(4):
        out[f"PY{k}"] = sum((s >> (8 * k + j)) & 1 for j in range(8)) % 2
    return out


# ---------------------------------------------------------------------------
# ISCAS89-class generators (sequential, DFF)
# ---------------------------------------------------------------------------

def _crc_taps(poly: int, nbits: int) -> list[int]:
    return [k for k in range(nbits) if (poly >> k) & 1]


def gen_crc(name_bits: int, poly: int, n_in: int, n_probe: int,
            steps: int = 1):
    """Galois-LFSR CRC advancing ``steps`` positions per clock (the extra
    advances are unrolled combinationally, matching the originals'
    combinational mass), ``n_in`` parallel inputs injected round-robin
    across the steps, ``n_probe`` state-parity probe outputs."""
    taps = _crc_taps(poly, name_bits)

    def gen():
        b = BenchBuilder()
        din = b.inps("D", n_in)
        q = [f"q{i}" for i in range(name_bits)]
        cur = list(q)                         # DFF outputs feed step 0
        for s in range(steps):
            ins = [din[j] for j in range(n_in) if j % steps == s]
            fb = cur[name_bits - 1]
            for extra in ins:
                fb = b._g("XOR", fb, extra)
            nxt = []
            for i in range(name_bits):
                if i == 0:
                    nxt.append(b._g("BUFF", fb) if fb in q or steps == 1
                               else fb)
                elif i in taps:
                    nxt.append(b._g("XOR", cur[i - 1], fb))
                else:
                    nxt.append(b._g("BUFF", cur[i - 1]))
            cur = nxt
        for i in range(name_bits):
            b.gates.append((q[i], "DFF", [cur[i]]))
        for k in range(n_probe):
            grp = [q[i] for i in range(name_bits) if i % n_probe == k]
            o = b.tree(b.xor, grp)
            b.gates.append((f"O{k}", "BUFF", [o]))
            b.out(f"O{k}")
        return b

    def golden_frames(frames, v):
        nb = next(iter(v.values())).shape[0]
        state = np.zeros((name_bits, nb), dtype=np.int64)
        outs = {}
        for t in range(frames):
            sfx = f"_f{t}" if frames > 1 else ""
            for k in range(n_probe):
                acc = np.zeros(nb, dtype=np.int64)
                for i in range(name_bits):
                    if i % n_probe == k:
                        acc ^= state[i]
                outs[f"O{k}{sfx}"] = acc
            for s in range(steps):
                fb = state[name_bits - 1].copy()
                for j in range(n_in):
                    if j % steps == s:
                        fb ^= v[f"D{j}{sfx}"]
                new = np.zeros_like(state)
                for i in range(name_bits):
                    if i == 0:
                        new[i] = fb
                    elif i in taps:
                        new[i] = state[i - 1] ^ fb
                    else:
                        new[i] = state[i - 1]
                state = new
        return outs

    return gen, golden_frames


def gen_s344r():
    """4x4 add-shift multiplier datapath (s344/s349 function class):
    state = 4-bit multiplicand copy + 8-bit accumulator + 3-bit counter."""
    b = BenchBuilder()
    A = b.inps("A", 4)           # multiplicand (sampled every clock)
    Bi = b.inps("B", 4)          # multiplier (shifted state)
    q_acc = [f"acc{i}" for i in range(8)]
    q_b = [f"qb{i}" for i in range(4)]
    # add A to acc[3:7] if LSB of B-state set, then shift acc right
    addend = [b.and_(A[i], q_b[0]) for i in range(4)]
    s, c = ripple_add(b, [q_acc[4 + i] for i in range(4)], addend,
                      b.and_(A[0], b.not_(A[0])))
    new_acc = q_acc[1:4] + s + [c]
    for i in range(8):
        b.gates.append((q_acc[i], "DFF", [new_acc[i]]))
    newb = q_b[1:] + [Bi[3]]
    for i, d in enumerate(newb):
        if isinstance(d, str) and d.startswith("qb"):
            cp = b._g("BUFF", d)
            b.gates.append((q_b[i], "DFF", [cp]))
        else:
            b.gates.append((q_b[i], "DFF", [d]))
    # load path: B inputs mix into state via XOR so inputs matter each frame
    for i in range(8):
        o = b.xor(q_acc[i], Bi[i % 4]) if i < 4 else b._g("BUFF", q_acc[i])
        b.gates.append((f"O{i}", "BUFF", [o]))
        b.out(f"O{i}")
    return b


def golden_s344r(frames, v):
    nb = next(iter(v.values())).shape[0]
    acc = np.zeros((8, nb), dtype=np.int64)
    qb = np.zeros((4, nb), dtype=np.int64)
    outs = {}
    for t in range(frames):
        sfx = f"_f{t}" if frames > 1 else ""
        A = [v[f"A{i}{sfx}"] for i in range(4)]
        Bi = [v[f"B{i}{sfx}"] for i in range(4)]
        for i in range(8):
            o = acc[i] ^ Bi[i % 4] if i < 4 else acc[i]
            outs[f"O{i}{sfx}"] = o
        addend = [A[i] & qb[0] for i in range(4)]
        hi = [acc[4 + i] for i in range(4)]
        c = np.zeros(nb, dtype=np.int64)
        s = []
        for x, y in zip(hi, addend):
            s.append(x ^ y ^ c)
            c = (x & y) | ((x ^ y) & c)
        new_acc = np.stack(list(acc[1:4]) + s + [c])
        new_qb = np.stack(list(qb[1:]) + [Bi[3]])
        acc, qb = new_acc, new_qb
    return outs


def gen_counter(nbits: int, n_dec: int):
    """Binary counter with enable + comparator decodes (traffic-controller /
    rate-multiplier size classes)."""
    def gen():
        b = BenchBuilder()
        en = b.inp("EN")
        lim = b.inps("L", nbits)
        q = [f"q{i}" for i in range(nbits)]
        c = en
        nxt = []
        for i in range(nbits):
            nxt.append(b.xor(q[i], c))
            c = b.and_(q[i], c)
        for i in range(nbits):
            b.gates.append((q[i], "DFF", [nxt[i]]))
        eq = b.tree(b.and_, [b.not_(b.xor(q[i], lim[i]))
                             for i in range(nbits)])
        b.gates.append(("EQ", "BUFF", [eq]))
        b.out("EQ")
        for k in range(n_dec):
            o = b.tree(b.xor, [q[i] for i in range(k, nbits, n_dec)])
            b.gates.append((f"O{k}", "BUFF", [o]))
            b.out(f"O{k}")
        return b

    def golden(frames, v):
        nb = next(iter(v.values())).shape[0]
        q = np.zeros((nbits, nb), dtype=np.int64)
        outs = {}
        for t in range(frames):
            sfx = f"_f{t}" if frames > 1 else ""
            lim = [v[f"L{i}{sfx}"] for i in range(nbits)]
            eq = np.ones(nb, dtype=np.int64)
            for i in range(nbits):
                eq &= (q[i] == lim[i]).astype(np.int64)
            outs[f"EQ{sfx}"] = eq
            for k in range(n_dec):
                acc = np.zeros(nb, dtype=np.int64)
                for i in range(k, nbits, n_dec):
                    acc ^= q[i]
                outs[f"O{k}{sfx}"] = acc
            en = v[f"EN{sfx}"]
            c = en.astype(np.int64)
            newq = np.zeros_like(q)
            for i in range(nbits):
                newq[i] = q[i] ^ c
                c = q[i] & c
            q = newq
        return outs

    return gen, golden


def gen_pla_fsm(n_state: int, n_in: int, n_out: int, n_terms: int,
                lits: int, o_terms: int, seed: int):
    """Moore FSM with a precisely specified seeded PLA core (the regen
    vehicle for the control-dominated ISCAS89 members — s382/s400/s444
    traffic-controller class, s386/s510/s820/s832/s953/s1488/s1494 PLD
    controllers — whose exact state tables are unpublished; state-bit
    counts and per-clock gate mass match the originals).

    Structure (the spec): product terms of ``lits`` literals over
    [state bits, primary inputs]; next_state[j] = state[j] XOR
    OR(term subset j); output[k] = OR(term subset k).
    """
    rng = np.random.default_rng(seed)
    n_sig = n_state + n_in
    terms = [(rng.choice(n_sig, size=lits, replace=False).tolist(),
              rng.integers(0, 2, lits).tolist()) for _ in range(n_terms)]
    nxt_sel = [rng.choice(n_terms, size=o_terms, replace=False).tolist()
               for _ in range(n_state)]
    out_sel = [rng.choice(n_terms, size=o_terms, replace=False).tolist()
               for _ in range(n_out)]

    def gen():
        b = BenchBuilder()
        din = b.inps("D", n_in)
        q = [f"q{i}" for i in range(n_state)]
        sig = q + din

        def lit(i, pol):
            return sig[i] if pol else b.not_(sig[i])

        tbits = [b.tree(b.and_, [lit(i, p) for i, p in zip(idx, pols)])
                 for idx, pols in terms]
        for j in range(n_state):
            b.gates.append((q[j], "DFF",
                            [b.xor(q[j], b.tree(b.or_,
                                                [tbits[t]
                                                 for t in nxt_sel[j]]))]))
        for k in range(n_out):
            o = b.tree(b.or_, [tbits[t] for t in out_sel[k]])
            b.gates.append((f"O{k}", "BUFF", [o]))
            b.out(f"O{k}")
        return b

    def golden(frames, v):
        nb = next(iter(v.values())).shape[0]
        state = np.zeros((n_state, nb), dtype=np.int64)
        outs = {}
        for t in range(frames):
            sfx = f"_f{t}" if frames > 1 else ""
            sig = list(state) + [v[f"D{j}{sfx}"] for j in range(n_in)]
            tv = []
            for idx, pols in terms:
                acc = np.ones(nb, dtype=np.int64)
                for i, p in zip(idx, pols):
                    acc &= sig[i] if p else 1 - sig[i]
                tv.append(acc)
            for k in range(n_out):
                outs[f"O{k}{sfx}"] = np.clip(
                    sum(tv[t2] for t2 in out_sel[k]), 0, 1)
            new = np.zeros_like(state)
            for j in range(n_state):
                new[j] = state[j] ^ np.clip(
                    sum(tv[t2] for t2 in nxt_sel[j]), 0, 1)
            state = new
        return outs

    return gen, golden


# ---------------------------------------------------------------------------
# Registry + verification + emission
# ---------------------------------------------------------------------------

# steps = combinational LFSR advances per clock, unrolled — sized so the
# per-clock gate count lands in the original's class (s641 379, s526 193,
# s1196 529, s1423 657, s5378 2779, s9234 5597 gates)
_crc16 = gen_crc(16, 0x8005, 2, 3, steps=16)
_crc21 = gen_crc(21, 0x10CAB5, 3, 3, steps=8)
_crc32a = gen_crc(32, 0x04C11DB7, 4, 4, steps=16)
_crc64 = gen_crc(64, 0x1B, 8, 6, steps=8)
_crc96 = gen_crc(96, 0x04C11DB7, 12, 8, steps=24)
_crc128 = gen_crc(128, 0x87, 16, 10, steps=32)
_cnt14 = gen_counter(14, 3)                # s298-class (14 DFFs)
_cnt16 = gen_counter(16, 4)                # s420-class
_cnt32 = gen_counter(32, 6)                # s838-class
# r5 additions toward the reference's full 30-circuit envelope
# (gen_makefile_iscas89.bash:14-43): exact rate-counter/CRC siblings ...
_cnt8 = gen_counter(8, 2)                  # s208-class (8 DFFs, 96 gates)
# ... PLA-FSM controllers (state-bit counts + per-clock gate mass match
# the originals: s382/400/444 traffic-light trio 21 DFFs ~160 gates,
# s386 6/159, s510 6/211, s820/s832 5/~290, s953 29/395, s1488/s1494
# 6/~650) ...
_s382 = gen_pla_fsm(21, 3, 6, 24, 3, 3, seed=382)
_s400 = gen_pla_fsm(21, 3, 6, 24, 3, 3, seed=400)
_s444 = gen_pla_fsm(21, 3, 6, 27, 3, 3, seed=4440)  # seed 444 degenerates to a constant circuit
_s386 = gen_pla_fsm(6, 7, 7, 26, 3, 3, seed=386)
_s510 = gen_pla_fsm(6, 19, 7, 30, 3, 3, seed=510)
_s820 = gen_pla_fsm(5, 18, 19, 40, 4, 4, seed=820)
_s832 = gen_pla_fsm(5, 18, 19, 40, 4, 4, seed=832)
_s953 = gen_pla_fsm(29, 16, 23, 45, 4, 3, seed=953)
_s1488 = gen_pla_fsm(6, 8, 19, 100, 4, 5, seed=1488)
_s1494 = gen_pla_fsm(6, 8, 19, 100, 4, 5, seed=1494)
# ... and the large sequential members as CRC banks (DFF counts match:
# s13207 638, s15850 534, s35932 1728, s38417 1636, s38584 1426; steps
# sized for the originals' per-clock combinational mass 8-22k gates)
_crc638 = gen_crc(638, 0x04C11DB7, 16, 10, steps=12)
_crc534 = gen_crc(534, 0x8005, 14, 10, steps=18)
_crc1728 = gen_crc(1728, 0x10CAB5, 32, 32, steps=9)
_crc1636 = gen_crc(1636, 0x04C11DB7, 28, 16, steps=13)
_crc1426 = gen_crc(1426, 0x87, 24, 12, steps=13)

REGEN85 = {
    "c432r": (gen_c432r, golden_c432r,
              "27-channel interrupt controller (c432 class)"),
    "c499r": (lambda: gen_c499r(False), golden_c499r,
              "32-bit single-error corrector (c499 function class)"),
    "c1355r": (lambda: gen_c499r(True), golden_c499r,
               "32-bit SEC, XORs expanded to NANDs (c1355 relation)"),
    "c880r": (gen_c880r, golden_c880r,
              "8-bit dual-74181 ALU (c880 class)"),
    "c1908r": (gen_c1908r, golden_c1908r,
               "16-bit SEC/DED (c1908 class)"),
    "c2670r": (gen_c2670r, golden_c2670r,
               "12-bit ALU + comparator (c2670 class)"),
    "c3540r": (gen_c3540r, golden_c3540r,
               "8-bit ALU with shifter (c3540 class)"),
    "c6288r": (gen_c6288r, golden_c6288r,
               "16x16 array multiplier (the exact c6288 function)"),
    "c7552r": (gen_c7552r, golden_c7552r,
               "32-bit adder/comparator (c7552 class)"),
}

REGEN89 = {
    "s208r": (_cnt8[0], _cnt8[1], "8-DFF rate counter (s208 class)"),
    "s298r": (_cnt14[0], _cnt14[1], "14-DFF counter/decoder (s298 class)"),
    "s344r": (gen_s344r, golden_s344r,
              "4x4 add-shift multiplier datapath (s344 class)"),
    "s349r": (gen_s344r, golden_s344r,
              "4x4 add-shift multiplier (s349 = s344 + redundancy; "
              "identical function)"),
    "s382r": (_s382[0], _s382[1],
              "21-DFF traffic-light controller class (s382)"),
    "s386r": (_s386[0], _s386[1], "6-DFF PLD controller class (s386)"),
    "s400r": (_s400[0], _s400[1],
              "21-DFF traffic-light controller class (s400; same trio "
              "function family as s382/s444)"),
    "s420r": (_cnt16[0], _cnt16[1], "16-DFF rate counter (s420 class)"),
    "s444r": (_s444[0], _s444[1],
              "21-DFF traffic-light controller class (s444)"),
    "s510r": (_s510[0], _s510[1], "6-DFF controller class (s510)"),
    "s526r": (_crc21[0], _crc21[1], "21-DFF LFSR/CRC (s526 class)"),
    "s641r": (_crc16[0], _crc16[1], "16-DFF CRC-16 (s641 class)"),
    "s713r": (_crc16[0], _crc16[1],
              "16-DFF CRC-16 (s713 = s641 + redundancy; identical "
              "function)"),
    "s820r": (_s820[0], _s820[1], "5-DFF PLD controller class (s820)"),
    "s832r": (_s832[0], _s832[1],
              "5-DFF PLD controller class (s832 = s820 sibling)"),
    "s838r": (_cnt32[0], _cnt32[1], "32-DFF counter (s838 class)"),
    "s953r": (_s953[0], _s953[1], "29-DFF controller class (s953)"),
    "s1196r": (_crc32a[0], _crc32a[1], "CRC-32 datapath (s1196 class)"),
    "s1238r": (_crc32a[0], _crc32a[1],
               "CRC-32 datapath (s1238 = s1196 + redundancy; identical "
               "function)"),
    "s1423r": (_crc64[0], _crc64[1], "64-DFF CRC (s1423 class)"),
    "s1488r": (_s1488[0], _s1488[1], "6-DFF controller class (s1488)"),
    "s1494r": (_s1494[0], _s1494[1],
               "6-DFF controller class (s1494 = s1488 sibling)"),
    "s5378r": (_crc96[0], _crc96[1], "96-DFF CRC bank (s5378 class)"),
    "s9234r": (_crc128[0], _crc128[1], "128-DFF CRC bank (s9234 class)"),
    "s13207r": (_crc638[0], _crc638[1], "638-DFF CRC bank (s13207 class)"),
    "s15850r": (_crc534[0], _crc534[1], "534-DFF CRC bank (s15850 class)"),
    "s35932r": (_crc1728[0], _crc1728[1],
                "1728-DFF CRC bank (s35932 class)"),
    "s38417r": (_crc1636[0], _crc1636[1],
                "1636-DFF CRC bank (s38417 class)"),
    "s38584r": (_crc1426[0], _crc1426[1],
                "1426-DFF CRC bank (s38584 class)"),
}


def verify_circuit(name: str, text: str, golden, sequential: bool,
                   n_vec: int = 200, frames: int = 3) -> None:
    from ..parsers import parse_bench
    rng = np.random.default_rng(42)
    if sequential:
        circ = parse_bench(text, unroll_frames=frames)
    else:
        circ = parse_bench(text)
    vals = {n.name: rng.integers(0, 2, n_vec) for n in circ.inputs}
    got = circ.eval(vals)
    want = golden(frames, vals) if sequential else golden(vals)
    for k, w in want.items():
        g = np.asarray(got[k]).astype(np.int64) & 1
        # constant-folded outputs come back as scalars: broadcast-compare
        assert np.all(g == (np.asarray(w) & 1)), f"{name}: output {k} mismatch"


def emit_all(base: str) -> list[str]:
    """Write every regenerated netlist under ``base``/iscas85 and
    ``base``/iscas89 (made if missing), each verified first."""
    import os
    for suite in ("iscas85", "iscas89"):
        os.makedirs(os.path.join(base, suite), exist_ok=True)
    written = []
    for name, (gen, golden, desc) in REGEN85.items():
        b = gen()
        text = b.serialize(
            f"{name} — regenerated functional equivalent: {desc}.\n"
            "Generated+verified by frontend/circuits/bench_regen.py "
            "(no-network regeneration; see module docstring).")
        verify_circuit(name, text, golden, sequential=False)
        path = os.path.join(base, "iscas85", f"{name}.bench")
        with open(path, "w") as f:
            f.write(text)
        written.append(path)
    for name, (gen, golden, desc) in REGEN89.items():
        b = gen()
        text = b.serialize(
            f"{name} — regenerated sequential equivalent: {desc}.\n"
            "Generated+verified by frontend/circuits/bench_regen.py.")
        verify_circuit(name, text, golden, sequential=True)
        path = os.path.join(base, "iscas89", f"{name}.bench")
        with open(path, "w") as f:
            f.write(text)
        written.append(path)
    return written


if __name__ == "__main__":
    import sys
    if len(sys.argv) != 2:
        sys.exit("usage: python -m tfhe_fbs_map_tpu_torch.frontend.circuits"
                 ".bench_regen OUT_DIR")
    base = sys.argv[1]
    for p in emit_all(base):
        print("wrote+verified", p)
