"""AES-128 as a Bristol-fashion boolean circuit, generated and verified.

The reference evaluates the public ``aes_128.txt`` Bristol circuit
(``experiments/gen_makefile_bristol.bash:4``,
``analyse_results.py:272-295``).  Instead of downloading the file we
REGENERATE a functionally identical
circuit from the FIPS-197 specification:

* S-box: the Boyar–Peralta minimal-multiplicative-complexity circuit
  (32 AND / 2-input-gate form; the same construction the public Bristol
  AES uses), sharing the nonlinear middle section with
  :func:`generators.aes_sbox`;
* ShiftRows: pure wiring; MixColumns: the GF(2^8) xtime bit-linear map as
  XOR gates; AddRoundKey: XORs; key schedule: RotWord/SubWord/Rcon.

Layout of the emitted file (old Bristol fashion, 2-input gates):
input1 = 128-bit plaintext, input2 = 128-bit key, output = 128-bit
ciphertext; bits are byte-major, MSB-first within each byte.  Every build
is verified in-process against a self-contained table AES (FIPS-197
appendix vectors + random cross-checks) before the file is written —
stronger provenance than an unverifiable download.
"""

from __future__ import annotations

__all__ = ["BristolEmitter", "emit_aes128", "aes128_reference",
           "verify_aes128_netlist"]


# ---------------------------------------------------------------------------
# Reference AES (cleartext, self-contained; tables from first principles)
# ---------------------------------------------------------------------------

def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        b >>= 1
        a = ((a << 1) ^ 0x11B) if a & 0x80 else (a << 1)
    return r


def _make_sbox() -> list[int]:
    # inverse via exponentiation (a^254), then the FIPS affine map
    sbox = []
    for a in range(256):
        inv = 0 if a == 0 else pow_gf(a, 254)
        res = 0x63  # affine constant
        for i in range(8):
            bit = ((inv >> i) ^ (inv >> ((i + 4) % 8)) ^ (inv >> ((i + 5) % 8))
                   ^ (inv >> ((i + 6) % 8)) ^ (inv >> ((i + 7) % 8))) & 1
            res ^= bit << i
        sbox.append(res & 0xFF)
    return sbox


def pow_gf(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf_mul(r, a)
        a = _gf_mul(a, a)
        e >>= 1
    return r


_SBOX = _make_sbox()
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _expand_key(key: bytes) -> list[list[int]]:
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [_SBOX[b] for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum((w[4 * r + c] for c in range(4)), []) for r in range(11)]


def aes128_reference(key: bytes, pt: bytes) -> bytes:
    """Self-contained AES-128 ECB encrypt of one block (FIPS-197)."""
    rks = _expand_key(key)
    s = [b ^ k for b, k in zip(pt, rks[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]
        # ShiftRows on column-major state: byte index 4c+r -> 4((c+r)%4)+r
        s = [s[4 * ((i // 4 + i % 4) % 4) + i % 4] for i in range(16)]
        if rnd < 10:
            ns = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                ns += [
                    _gf_mul(a[0], 2) ^ _gf_mul(a[1], 3) ^ a[2] ^ a[3],
                    a[0] ^ _gf_mul(a[1], 2) ^ _gf_mul(a[2], 3) ^ a[3],
                    a[0] ^ a[1] ^ _gf_mul(a[2], 2) ^ _gf_mul(a[3], 3),
                    _gf_mul(a[0], 3) ^ a[1] ^ a[2] ^ _gf_mul(a[3], 2),
                ]
            s = ns
        s = [b ^ k for b, k in zip(s, rks[rnd])]
    return bytes(s)


# ---------------------------------------------------------------------------
# Bristol netlist emitter
# ---------------------------------------------------------------------------

class BristolEmitter:
    """Builds an old-Bristol-fashion 2-input gate list.

    Wires are symbolic until :meth:`serialize`, which renumbers so the
    declared output signals occupy the final indices (the format's output
    convention — parsers.py:199-201)."""

    def __init__(self, n_in1: int, n_in2: int):
        self.n_inputs = n_in1 + n_in2
        self.in_spec = (n_in1, n_in2)
        self.gates: list[tuple[str, tuple[int, ...], int]] = []
        self._next = self.n_inputs
        self._zero = None
        self._one = None

    def inputs(self) -> list[int]:
        return list(range(self.n_inputs))

    def _new(self) -> int:
        w = self._next
        self._next += 1
        return w

    def gate(self, op: str, *ins: int) -> int:
        out = self._new()
        self.gates.append((op, tuple(ins), out))
        return out

    def xor(self, a: int, b: int) -> int:
        return self.gate("XOR", a, b)

    def and_(self, a: int, b: int) -> int:
        return self.gate("AND", a, b)

    def inv(self, a: int) -> int:
        return self.gate("INV", a)

    def xor_many(self, *ws: int) -> int:
        acc = ws[0]
        for w in ws[1:]:
            acc = self.xor(acc, w)
        return acc

    def serialize(self, outputs: list[int]) -> str:
        n_out = len(outputs)
        total = self._next
        # renumber: outputs -> the last n_out indices (in declared order);
        # every other wire keeps relative order.  Output signals must not
        # feed later gates under the old format; AES ciphertext bits are
        # terminal so this holds (asserted).
        out_set = set(outputs)
        assert len(out_set) == n_out, "duplicate output wires"
        for op, ins, out in self.gates:
            assert not (set(ins) & out_set), \
                "output wire consumed by a gate — not old-Bristol-legal"
        remap: dict[int, int] = {}
        nxt = 0
        for w in range(total):
            if w not in out_set:
                remap[w] = nxt
                nxt += 1
        for j, w in enumerate(outputs):
            remap[w] = total - n_out + j
        lines = [f"{len(self.gates)} {total}",
                 f"2 {self.in_spec[0]} {self.in_spec[1]}",
                 f"1 {n_out}"]
        for op, ins, out in self.gates:
            ins_m = [remap[w] for w in ins]
            lines.append(f"{len(ins)} 1 " + " ".join(map(str, ins_m))
                         + f" {remap[out]} {op}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Boyar–Peralta S-box over the emitter (bytes = 8 wires, MSB first)
# ---------------------------------------------------------------------------

def _sbox_circuit(e: BristolEmitter, u: list[int]) -> list[int]:
    """BP forward S-box: U0..U7 (U0 = MSB) -> S0..S7 (S0 = MSB).

    Top/bottom linear layers around the shared nonlinear middle section
    (generators.py:56-118, the published BP construction)."""
    U = u
    x = e.xor
    # top linear layer
    y14 = x(U[3], U[5])
    y13 = x(U[0], U[6])
    y9 = x(U[0], U[3])
    y8 = x(U[0], U[5])
    t0 = x(U[1], U[2])
    y1 = x(t0, U[7])
    y4 = x(y1, U[3])
    y12 = x(y13, y14)
    y2 = x(y1, U[0])
    y5 = x(y1, U[6])
    y3 = x(y5, y8)
    t1 = x(U[4], y12)
    y15 = x(t1, U[5])
    y20 = x(t1, U[1])
    y6 = x(y15, U[7])
    y10 = x(y15, t0)
    y11 = x(y20, y9)
    y7 = x(U[7], y11)
    y17 = x(y10, y11)
    y19 = x(y10, y8)
    y16 = x(t0, y11)
    y21 = x(y13, y16)
    y18 = x(U[0], y16)
    y = [None, y1, y2, y3, y4, y5, y6, y7, y8, y9, y10, y11, y12, y13,
         y14, y15, y16, y17, y18, y19, y20, y21]
    x7 = U[7]

    # shared nonlinear middle section (generators.aes_sbox gate list)
    a = e.and_
    t2 = a(y[12], y[15])
    t3 = a(y[3], y[6])
    t4 = x(t3, t2)
    t5 = a(y[4], x7)
    t6 = x(t5, t2)
    t7 = a(y[13], y[16])
    t8 = a(y[5], y[1])
    t9 = x(t8, t7)
    t10 = a(y[2], y[7])
    t11 = x(t10, t7)
    t12 = a(y[9], y[11])
    t13 = a(y[14], y[17])
    t14 = x(t13, t12)
    t15 = a(y[8], y[10])
    t16 = x(t15, t12)
    t17 = x(t4, t14)
    t18 = x(t6, t16)
    t19 = x(t9, t14)
    t20 = x(t11, t16)
    t21 = x(t17, y[20])
    t22 = x(t18, y[19])
    t23 = x(t19, y[21])
    t24 = x(t20, y[18])
    t25 = x(t21, t22)
    t26 = a(t21, t23)
    t27 = x(t24, t26)
    t28 = a(t25, t27)
    t29 = x(t28, t22)
    t30 = x(t23, t24)
    t31 = x(t22, t26)
    t32 = a(t31, t30)
    t33 = x(t32, t24)
    t34 = x(t23, t33)
    t35 = x(t27, t33)
    t36 = a(t24, t35)
    t37 = x(t36, t34)
    t38 = x(t27, t36)
    t39 = a(t29, t38)
    t40 = x(t25, t39)
    t41 = x(t40, t37)
    t42 = x(t29, t33)
    t43 = x(t29, t40)
    t44 = x(t33, t37)
    t45 = x(t42, t41)
    z = [a(t44, y[15]), a(t37, y[6]), a(t33, x7), a(t43, y[16]),
         a(t40, y[1]), a(t29, y[7]), a(t42, y[11]), a(t45, y[17]),
         a(t41, y[10]), a(t44, y[12]), a(t37, y[3]), a(t33, y[4]),
         a(t43, y[13]), a(t40, y[5]), a(t29, y[2]), a(t42, y[9]),
         a(t45, y[14]), a(t41, y[8])]

    # bottom linear layer
    t46 = x(z[15], z[16])
    t47 = x(z[10], z[11])
    t48 = x(z[5], z[13])
    t49 = x(z[9], z[10])
    t50 = x(z[2], z[12])
    t51 = x(z[2], z[5])
    t52 = x(z[7], z[8])
    t53 = x(z[0], z[3])
    t54 = x(z[6], z[7])
    t55 = x(z[16], z[17])
    t56 = x(z[12], t48)
    t57 = x(t50, t53)
    t58 = x(z[4], t46)
    t59 = x(z[3], t54)
    t60 = x(t46, t57)
    t61 = x(z[14], t57)
    t62 = x(t52, t58)
    t63 = x(t49, t58)
    t64 = x(z[4], t59)
    t65 = x(t61, t62)
    t66 = x(z[1], t63)
    s0 = x(t59, t63)
    s6 = e.gate("XNOR", t56, t62)
    s7 = e.gate("XNOR", t48, t60)
    t67 = x(t64, t65)
    s3 = x(t53, t66)
    s4 = x(t51, t66)
    s5 = x(t47, t65)
    s1 = e.gate("XNOR", t64, s3)
    s2 = e.gate("XNOR", t55, t67)
    return [s0, s1, s2, s3, s4, s5, s6, s7]


def _xtime(e: BristolEmitter, u: list[int]) -> list[int]:
    """GF(2^8) doubling on an MSB-first bit list."""
    x = e.xor
    return [u[1], u[2], u[3], x(u[4], u[0]), x(u[5], u[0]), u[6],
            x(u[7], u[0]), u[0]]


def _xor_bytes(e, a, b):
    return [e.xor(p, q) for p, q in zip(a, b)]


def _xor_const(e, a: list[int], c: int) -> list[int]:
    return [e.inv(w) if (c >> (7 - j)) & 1 else w for j, w in enumerate(a)]


def build_aes128(e: BristolEmitter) -> list[int]:
    """Emit the full AES-128 encryption; returns the 128 ciphertext wires."""
    ws = e.inputs()
    pt = [ws[8 * i:8 * i + 8] for i in range(16)]            # bytes, MSB-first
    key = [ws[128 + 8 * i:128 + 8 * i + 8] for i in range(16)]

    def sub_word(word):                                      # 4 bytes
        return [_sbox_circuit(e, b) for b in word]

    # key schedule (words = 4 bytes)
    w = [key[4 * i:4 * i + 4] for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = sub_word(t[1:] + t[:1])
            t[0] = _xor_const(e, t[0], _RCON[i // 4 - 1])
        w.append([_xor_bytes(e, a, b) for a, b in zip(w[i - 4], t)])
    rks = [sum((w[4 * r + c] for c in range(4)), []) for r in range(11)]

    s = [_xor_bytes(e, pt[i], rks[0][i]) for i in range(16)]
    for rnd in range(1, 11):
        s = [_sbox_circuit(e, b) for b in s]
        s = [s[4 * ((i // 4 + i % 4) % 4) + i % 4] for i in range(16)]
        if rnd < 10:
            ns = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                xt = [_xtime(e, b) for b in a]
                ns += [
                    e.xor_many3(xt[0], _xor_bytes(e, xt[1], a[1]),
                                _xor_bytes(e, a[2], a[3])),
                    e.xor_many3(a[0], _xor_bytes(e, xt[1], xt[2]),
                                _xor_bytes(e, a[2], a[3])),
                    e.xor_many3(a[0], _xor_bytes(e, a[1], xt[2]),
                                _xor_bytes(e, xt[3], a[3])),
                    e.xor_many3(_xor_bytes(e, xt[0], a[0]),
                                _xor_bytes(e, a[1], a[2]), xt[3]),
                ]
            s = ns
        s = [_xor_bytes(e, s[i], rks[rnd][i]) for i in range(16)]
    return sum(s, [])


def _xor_many3(self, a, b, c):
    return [self.xor(self.xor(p, q), r) for p, q, r in zip(a, b, c)]


BristolEmitter.xor_many3 = _xor_many3


# ---------------------------------------------------------------------------
# Verified emission
# ---------------------------------------------------------------------------

def _eval_netlist(text: str, in_bits: list[int]) -> list[int]:
    lines = [ln.split() for ln in text.splitlines() if ln.strip()]
    n_gates, total = int(lines[0][0]), int(lines[0][1])
    n_out = int(lines[2][1])
    vals = {i: b for i, b in enumerate(in_bits)}
    ops = {"XOR": lambda a, b: a ^ b, "AND": lambda a, b: a & b,
           "XNOR": lambda a, b: 1 - (a ^ b), "OR": lambda a, b: a | b}
    for parts in lines[3:3 + n_gates]:
        n_in = int(parts[0])
        ins = [int(p) for p in parts[2:2 + n_in]]
        out = int(parts[2 + n_in])
        op = parts[3 + n_in]
        if op in ("INV", "NOT"):
            vals[out] = 1 - vals[ins[0]]
        else:
            vals[out] = ops[op](vals[ins[0]], vals[ins[1]])
    return [vals[w] for w in range(total - n_out, total)]


def _bytes_to_bits(bs: bytes) -> list[int]:
    return [(b >> (7 - j)) & 1 for b in bs for j in range(8)]


def _bits_to_bytes(bits: list[int]) -> bytes:
    return bytes(sum(bits[8 * i + j] << (7 - j) for j in range(8))
                 for i in range(len(bits) // 8))


def verify_aes128_netlist(text: str, n_random: int = 2) -> None:
    """FIPS-197 appendix-C vector plus random cross-checks; raises on any
    mismatch (the emitted file is only written after this passes)."""
    import numpy as np
    key = bytes(range(16))
    pt = bytes(int(f"{h}{h}", 16) for h in "0123456789abcdef")
    want = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    assert aes128_reference(key, pt) == want, "reference AES is wrong"
    rng = np.random.default_rng(0)
    cases = [(key, pt)]
    for _ in range(n_random):
        cases.append((bytes(rng.integers(0, 256, 16, dtype=np.uint8)),
                      bytes(rng.integers(0, 256, 16, dtype=np.uint8))))
    for k, p in cases:
        got = _bits_to_bytes(_eval_netlist(
            text, _bytes_to_bits(p) + _bytes_to_bits(k)))
        assert got == aes128_reference(k, p), \
            f"netlist mismatch for key={k.hex()} pt={p.hex()}"


def emit_aes128(path: str | None = None) -> str:
    """Build, verify, and (optionally) write the AES-128 Bristol circuit."""
    e = BristolEmitter(128, 128)
    outs = build_aes128(e)
    text = e.serialize(outs)
    verify_aes128_netlist(text)
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


if __name__ == "__main__":
    import sys
    if len(sys.argv) != 2:
        sys.exit("usage: python -m tfhe_fbs_map_tpu_torch.frontend.circuits"
                 ".aes128 OUT.txt")
    out = sys.argv[1]
    text = emit_aes128(out)
    first = text.splitlines()[0]
    print(f"wrote {out}: {first} (gates wires), verified vs FIPS-197")
