"""EPFL random_control + remaining arithmetic regenerations.

The reference sweeps every BLIF in the EPFL suite's ``arithmetic/`` AND
``random_control/`` directories
(``experiments/gen_makefile_epfl.bash:8-9``).  The
canonical netlists are public; rather than download them, each
member is (following the convention established by ``bench_regen.py``)
REGENERATED from its documented function and verified against a
numpy golden model before use:

* **exact-function members** (the function is fully determined by the
  benchmark's name/signature): ``dec`` 8→256 decoder, ``priority``
  128-bit priority encoder, ``voter`` 1001-input majority, ``div``
  64/64 restoring divider, ``sqrt`` 128-bit integer square root,
  ``int2float`` 11-bit→7-bit float conversion (our precise rounding
  spec documented on the generator);
* **controller members** (``ctrl``, ``cavlc``, ``router``, ``i2c``): the
  originals are specific control tables with no published functional
  spec; the regenerations implement a PRECISELY SPECIFIED seeded
  two-level PLA of the same I/O signature and gate-count class, so
  mapping-cost comparisons are size-class comparisons (analyse.py marks
  regenerated suites accordingly);
* ``arbiter``: a cyclic round-robin arbiter with the original's 256/129
  signature (the documented architecture) and our own precise priority
  rule; gate count is below the original's (the original carries
  redundant logic), noted here for honesty.

Original EPFL gate counts for the size-class record: arbiter 11839,
cavlc 693, ctrl 174, dec 304, i2c 1342, int2float 260, priority 978,
router 257, voter 13758, div 57247, sqrt 24618.
"""

from __future__ import annotations

import numpy as np

from ..bit_circuit import BitCircuit
from .dsl import Bit, CircuitBuilder

__all__ = ["EPFL_CONTROL_GENERATORS", "EPFL_CONTROL_GOLDEN"]


# ---------------------------------------------------------------------------
# Bit-list helpers
# ---------------------------------------------------------------------------

def _tree(op, bits):
    bits = list(bits)
    assert bits
    while len(bits) > 1:
        nxt = [op(bits[i], bits[i + 1]) for i in range(0, len(bits) - 1, 2)]
        if len(bits) % 2:
            nxt.append(bits[-1])
        bits = nxt
    return bits[0]


def _or_tree(bits):
    return _tree(lambda a, b: a | b, bits)


def _and_tree(bits):
    return _tree(lambda a, b: a & b, bits)


def _mux(s, a, x):
    """s ? a : x (3 gates)."""
    return x ^ (s & (a ^ x))


def _full_add(x, y, c):
    s1 = x ^ y
    return s1 ^ c, (x & y) | (s1 & c)


def _sub_borrow(xs, ys, bin_):
    """xs - ys - bin (LSB-first, equal length): (diff bits, borrow out)."""
    out, b = [], bin_
    for x, y in zip(xs, ys):
        d = x ^ y ^ b
        b = ((~x) & y) | ((~(x ^ y)) & b)
        out.append(d)
    return out, b


def _popcount(b, bits):
    """Carry-save popcount; returns LSB-first sum bits."""
    cols: dict[int, list] = {0: list(bits)}
    while any(len(v) > 1 for v in cols.values()):
        nxt: dict[int, list] = {}
        for k in sorted(cols):
            col = cols[k]
            i = 0
            while len(col) - i >= 3:
                s, c = _full_add(col[i], col[i + 1], col[i + 2])
                nxt.setdefault(k, []).append(s)
                nxt.setdefault(k + 1, []).append(c)
                i += 3
            if len(col) - i == 2:
                nxt.setdefault(k, []).append(col[i] ^ col[i + 1])
                nxt.setdefault(k + 1, []).append(col[i] & col[i + 1])
            elif len(col) - i == 1:
                nxt.setdefault(k, []).append(col[i])
        cols = nxt
    return [cols[k][0] for k in sorted(cols) if cols[k]]


# ---------------------------------------------------------------------------
# Exact-function members
# ---------------------------------------------------------------------------

def epfl_dec() -> BitCircuit:
    """EPFL ``dec``: 8→256 binary decoder (exact function), built as two
    4→16 pre-decoders + a 16×16 AND plane (the original's shared form)."""
    b = CircuitBuilder()
    a = b.inputs("a{}", 8)

    def pre(dbits):
        lits = [(~x, x) for x in dbits]
        return [_and_tree([lits[k][(i >> k) & 1] for k in range(4)])
                for i in range(16)]
    lo, hi = pre(a[:4]), pre(a[4:])
    for i in range(256):
        (hi[i >> 4] & lo[i & 15]).output(f"o{i}")
    return b.circuit


def golden_dec(vals):
    x = sum(np.asarray(vals[f"a{i}"], dtype=np.int64) << i for i in range(8))
    return {f"o{i}": (x == i).astype(np.int64) for i in range(256)}


def epfl_priority() -> BitCircuit:
    """EPFL ``priority``: 128-line priority encoder (exact function):
    7-bit index of the LOWEST-index active request + a valid flag."""
    b = CircuitBuilder()
    r = b.inputs("r{}", 128)
    found, any_so_far = [], None
    for i in range(128):
        if any_so_far is None:
            found.append(r[i])
            any_so_far = r[i]
        else:
            found.append(r[i] & ~any_so_far)
            any_so_far = any_so_far | r[i]
    for k in range(7):
        _or_tree([found[i] for i in range(128) if (i >> k) & 1]) \
            .output(f"idx{k}")
    any_so_far.output("valid")
    return b.circuit


def golden_priority(vals):
    r = np.stack([vals[f"r{i}"] for i in range(128)]).astype(np.int64)
    any_ = r.any(0)
    idx = np.where(any_, np.argmax(r, axis=0), 0)
    out = {f"idx{k}": (idx >> k) & 1 for k in range(7)}
    out["valid"] = any_.astype(np.int64)
    return out


def epfl_int2float() -> BitCircuit:
    """EPFL ``int2float``: 11-bit unsigned integer → 7-bit float
    (3-bit exponent e, 4-bit mantissa m; value = m·2^e, truncating
    normalization: e = max(0, msb(x) − 3), m = x >> e).  Our precise
    rounding spec — the original's exact table is unpublished."""
    b = CircuitBuilder()
    x = b.inputs("x{}", 11)
    # one-hot msb position
    found, any_so_far = [], None
    for i in range(10, -1, -1):
        if any_so_far is None:
            found.append((i, x[i]))
            any_so_far = x[i]
        else:
            found.append((i, x[i] & ~any_so_far))
            any_so_far = any_so_far | x[i]
    msb_is = dict(found)
    # e = clamp(msb-3, 0): one-hot over e in 0..7
    e_onehot = []
    for e in range(8):
        if e == 0:
            e_onehot.append(_or_tree([msb_is[i] for i in range(0, 4)]
                                     + [~any_so_far]))
        else:
            e_onehot.append(msb_is[e + 3])
    for k in range(3):
        _or_tree([e_onehot[e] for e in range(8) if (e >> k) & 1]) \
            .output(f"e{k}")
    # m = (x >> e) & 15 selected by the one-hot exponent
    for j in range(4):
        terms = []
        for e in range(8):
            if e + j < 11:
                terms.append(e_onehot[e] & x[e + j])
        _or_tree(terms).output(f"m{j}")
    return b.circuit


def golden_int2float(vals):
    x = sum(np.asarray(vals[f"x{i}"], dtype=np.int64) << i
            for i in range(11))
    e = np.array([max(0, (int(v).bit_length() - 1) - 3) if v > 0 else 0
                  for v in x], dtype=np.int64)
    m = (x >> e) & 15
    out = {f"e{k}": (e >> k) & 1 for k in range(3)}
    out.update({f"m{j}": (m >> j) & 1 for j in range(4)})
    return out


def epfl_voter() -> BitCircuit:
    """EPFL ``voter``: majority of 1001 inputs (exact function): popcount
    carry-save tree + comparison against 501."""
    b = CircuitBuilder()
    xs = b.inputs("x{}", 1001)
    s = _popcount(b, xs)                      # 10 bits
    # s >= 501 <=> s + 523 >= 1024 (10-bit carry out of s + 523)
    k = 1024 - 501
    c = b.const(0)
    for i in range(10):
        kb = (k >> i) & 1
        x = s[i]
        if kb:
            # x + 1 + c: sum irrelevant; carry = x | c
            c = x | c
        else:
            c = x & c
    c.output("maj")
    return b.circuit


def golden_voter(vals):
    s = sum(np.asarray(vals[f"x{i}"], dtype=np.int64) for i in range(1001))
    return {"maj": (s >= 501).astype(np.int64)}


def epfl_arbiter() -> BitCircuit:
    """EPFL ``arbiter`` signature (256 in / 129 out): cyclic round-robin —
    the pointer is the lowest set bit of ``pri`` (position 0 when none);
    the grant goes to the first request at or after the pointer in cyclic
    order; ``any`` reports a grant.  Precise rule of our own in the
    documented architecture (the original's netlist carries ~8x more
    redundant logic)."""
    b = CircuitBuilder()
    req = b.inputs("req{}", 128)
    pri = b.inputs("pri{}", 128)
    # pointer one-hot = lowest set pri bit; th_i = (pointer <= i)
    th, any_p = [], None
    for i in range(128):
        if any_p is None:
            any_p = pri[i]
        else:
            any_p = any_p | pri[i]
        th.append(any_p)
    masked = [req[i] & th[i] for i in range(128)]
    gm, any_m = [], None
    for i in range(128):
        if any_m is None:
            gm.append(masked[i])
            any_m = masked[i]
        else:
            gm.append(masked[i] & ~any_m)
            any_m = any_m | masked[i]
    gu, any_u = [], None
    for i in range(128):
        if any_u is None:
            gu.append(req[i])
            any_u = req[i]
        else:
            gu.append(req[i] & ~any_u)
            any_u = any_u | req[i]
    for i in range(128):
        _mux(any_m, gm[i], gu[i]).output(f"g{i}")
    any_u.output("any")
    return b.circuit


def golden_arbiter(vals):
    req = np.stack([vals[f"req{i}"] for i in range(128)]).astype(np.int64)
    pri = np.stack([vals[f"pri{i}"] for i in range(128)]).astype(np.int64)
    nb = req.shape[1]
    out = {f"g{i}": np.zeros(nb, np.int64) for i in range(128)}
    grants = np.full(nb, -1)
    ptr = np.where(pri.any(0), np.argmax(pri, axis=0), 0)
    for v in range(nb):
        # first request at or after the pointer, else plain priority
        masked = [i for i in range(ptr[v], 128) if req[i, v]]
        if masked:
            grants[v] = masked[0]
        else:
            plain = [i for i in range(128) if req[i, v]]
            if plain:
                grants[v] = plain[0]
    for v in range(nb):
        if grants[v] >= 0:
            out[f"g{grants[v]}"][v] = 1
    out["any"] = req.any(0).astype(np.int64)
    return out


def epfl_div() -> BitCircuit:
    """EPFL ``div`` signature (128 in / 128 out): 64/64 restoring divider
    (exact function): q = a // d, r = a % d; d = 0 yields q = 2^64−1,
    r = a (the restoring datapath's natural behavior)."""
    b = CircuitBuilder()
    a = b.inputs("a{}", 64)
    d = b.inputs("d{}", 64)
    r = [b.const(0) for _ in range(64)]
    q = [None] * 64
    for i in range(63, -1, -1):
        t = r[63]                      # shifted-out top bit
        shifted = [a[i]] + r[:63]
        diff, borrow = _sub_borrow(shifted, d, b.const(0))
        ge = t | ~borrow
        r = [_mux(ge, diff[j], shifted[j]) for j in range(64)]
        q[i] = ge
    for i in range(64):
        q[i].output(f"q{i}")
    for i in range(64):
        r[i].output(f"r{i}")
    return b.circuit


def golden_div(vals):
    a = sum(np.asarray(vals[f"a{i}"], dtype=object) << i for i in range(64))
    d = sum(np.asarray(vals[f"d{i}"], dtype=object) << i for i in range(64))
    nb = len(np.asarray(vals["a0"]))
    q = np.zeros(nb, dtype=object)
    r = np.zeros(nb, dtype=object)
    for v in range(nb):
        if d[v] == 0:
            q[v], r[v] = (1 << 64) - 1, a[v]
        else:
            q[v], r[v] = a[v] // d[v], a[v] % d[v]
    out = {f"q{i}": np.array([(int(x) >> i) & 1 for x in q], dtype=np.int64)
           for i in range(64)}
    out.update({f"r{i}": np.array([(int(x) >> i) & 1 for x in r],
                                  dtype=np.int64) for i in range(64)})
    return out


def epfl_sqrt() -> BitCircuit:
    """EPFL ``sqrt``: floor square root of a 128-bit integer (exact
    function), restoring digit recurrence with width-growing remainder."""
    b = CircuitBuilder()
    n = b.inputs("n{}", 128)
    rem: list = []                      # LSB-first, grows per step
    root: list = []                     # LSB-first, grows per step
    for t in range(64):
        i = 63 - t
        rem = [n[2 * i], n[2 * i + 1]] + rem          # rem = rem<<2 | pair
        # invariant: rem = N_high − root² ≤ 2·root before the shift, so
        # the shifted remainder fits t+4 bits — cap the width (higher
        # lanes are provably zero; the golden-model test enforces it)
        w = min(len(rem) + 1, t + 4)
        rem = (rem + [b.const(0)])[:w]
        trial = ([b.const(1), b.const(0)] + root
                 + [b.const(0)] * w)[:w]               # 4*root + 1
        diff, borrow = _sub_borrow(rem, trial, b.const(0))
        ge = ~borrow
        rem = [_mux(ge, diff[j], rem[j]) for j in range(w)]
        root = [ge] + root
    for i in range(64):
        root[i].output(f"s{i}")
    return b.circuit


def golden_sqrt(vals):
    n = sum(np.asarray(vals[f"n{i}"], dtype=object) << i for i in range(128))
    out = {}
    s = np.array([int(np.sqrt(float(x))) for x in n], dtype=object)
    # float sqrt is inexact at 128 bits: fix up exactly
    for v in range(len(s)):
        x = int(n[v])
        r = int(s[v])
        while r * r > x:
            r -= 1
        while (r + 1) * (r + 1) <= x:
            r += 1
        s[v] = r
    for i in range(64):
        out[f"s{i}"] = np.array([(int(x) >> i) & 1 for x in s],
                                dtype=np.int64)
    return out


# ---------------------------------------------------------------------------
# Controller members: precisely specified seeded PLA
# ---------------------------------------------------------------------------

def _pla_spec(seed: int, n_in: int, n_out: int, n_terms: int, lits: int,
              o_terms: int):
    """Deterministic PLA structure: ``n_terms`` product terms of ``lits``
    literals (random inputs/polarities), each output ORs ``o_terms``
    terms.  The structure IS the spec — builder and golden model both
    derive from it."""
    rng = np.random.default_rng(seed)
    terms = [(rng.choice(n_in, size=lits, replace=False).tolist(),
              rng.integers(0, 2, lits).tolist()) for _ in range(n_terms)]
    outs = [rng.choice(n_terms, size=o_terms, replace=False).tolist()
            for _ in range(n_out)]
    # every input must appear in a LIVE term (the original signatures have
    # no dangling PIs): uncovered inputs get a 2-literal term attached
    # round-robin
    live = {t for sel in outs for t in sel}
    used = {i for t in live for i in terms[t][0]}
    for i in range(n_in):
        if i not in used:
            outs[i % n_out].append(len(terms))
            terms.append(([i, (i + 1) % n_in], [1, 1]))
    return terms, outs


def _pla_generator(name: str, seed: int, n_in: int, n_out: int,
                   n_terms: int, lits: int, o_terms: int):
    terms, outs = _pla_spec(seed, n_in, n_out, n_terms, lits, o_terms)

    def gen() -> BitCircuit:
        b = CircuitBuilder()
        ins = b.inputs("i{}", n_in)
        tbits = [_and_tree([ins[i] if pol else ~ins[i]
                            for i, pol in zip(idx, pols)])
                 for idx, pols in terms]
        for o, sel in enumerate(outs):
            _or_tree([tbits[t] for t in sel]).output(f"o{o}")
        return b.circuit

    def golden(vals):
        x = np.stack([vals[f"i{i}"] for i in range(n_in)]).astype(np.int64)
        tv = []
        for idx, pols in terms:
            acc = np.ones_like(x[0])
            for i, pol in zip(idx, pols):
                acc &= x[i] if pol else 1 - x[i]
            tv.append(acc)
        return {f"o{o}": np.clip(sum(tv[t] for t in sel), 0, 1)
                for o, sel in enumerate(outs)}

    gen.__name__ = f"epfl_{name}"
    return gen, golden


_ctrl = _pla_generator("ctrl", 20250, 7, 26, 30, 3, 5)
_cavlc = _pla_generator("cavlc", 20251, 10, 11, 120, 4, 16)
_router = _pla_generator("router", 20252, 60, 30, 40, 3, 6)
_i2c = _pla_generator("i2c", 20253, 147, 142, 160, 3, 6)


EPFL_CONTROL_GENERATORS = {
    "dec": epfl_dec,
    "priority": epfl_priority,
    "int2float": epfl_int2float,
    "voter": epfl_voter,
    "arbiter": epfl_arbiter,
    "ctrl": _ctrl[0],
    "cavlc": _cavlc[0],
    "router": _router[0],
    "i2c": _i2c[0],
    "div": epfl_div,
    "sqrt": epfl_sqrt,
}

EPFL_CONTROL_GOLDEN = {
    "dec": golden_dec,
    "priority": golden_priority,
    "int2float": golden_int2float,
    "voter": golden_voter,
    "arbiter": golden_arbiter,
    "ctrl": _ctrl[1],
    "cavlc": _cavlc[1],
    "router": _router[1],
    "i2c": _i2c[1],
    "div": golden_div,
    "sqrt": golden_sqrt,
}
