"""The least time an H100 needs for a level's bootstraps: the yardstick of
``kernel_roofline`` and ``eval_roofline``.

Frozen counts of the algorithm's work, whatever implements it:

* a blind rotation of one ciphertext is n CMux steps, each the product of
  its (k+1)·l·N gadget digits with a (k+1)·l·N × (k+1)·N key matrix whose
  32-bit entries are four int8 limbs: 2·n·(k+1)·l·N·4·(k+1)·N int8
  operations; it reads the compact bootstrapping key once (n·(k+1)·l·(k+1)·N
  int32), the small ciphertext and the test polynomial, and writes the
  accumulator;
* the key switch before it is a product of the kN·l_ks digits with the
  kN·l_ks × (n+1) key at four limbs: 2·kN·l_ks·(n+1)·4 operations, reading
  the key-switching key once and the big ciphertext, writing the small one.

Only real bootstraps count (padding slots count nothing), at the
algorithm's four limbs whatever the key that was built.  The least time of a
call is the larger of its operations over the int8 peak and its bytes over
the memory rate (NVIDIA's data sheet, H100 SXM, dense, at 700 W).
"""

from __future__ import annotations

__all__ = ["PEAK_INT8_OPS", "PEAK_BYTES", "LIMBS", "rotation",
           "keyswitch_ops", "least_s", "call_least_s"]

PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
LIMBS = 4
WORD = 4                   # bytes of a torus element


def rotation(fam: dict, boots: int) -> tuple[float, float]:
    """(int8 operations, bytes) of ``boots`` blind rotations."""
    n, k1, N, l = fam["lwe_dim"], fam["glwe_dim"] + 1, fam["poly_size"], \
        fam["bsk_level"]
    ops = 2 * n * boots * (k1 * l * N) * LIMBS * k1 * N
    key = n * k1 * l * k1 * N * WORD
    io = boots * ((n + 1) + N + k1 * N) * WORD
    return float(ops), float(key + io)


def keyswitch_ops(fam: dict, boots: int) -> float:
    """int8 operations of ``boots`` key switches."""
    kn = fam["glwe_dim"] * fam["poly_size"]
    return float(2 * boots * kn * fam["ksk_level"] * (fam["lwe_dim"] + 1)
                 * LIMBS)


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)


def call_least_s(fam: dict, boots: int) -> tuple[float, float]:
    """(rotation alone, whole bootstrap) least seconds of one call of
    ``boots`` real bootstraps of family ``fam``; 0 for none."""
    if boots <= 0:
        return 0.0, 0.0
    r_ops, r_bytes = rotation(fam, boots)
    # the whole bootstrap's bytes: both keys, the big ciphertext in and
    # out, the test polynomial
    kn1 = fam["glwe_dim"] * fam["poly_size"] + 1
    n, k1, N, l = fam["lwe_dim"], fam["glwe_dim"] + 1, fam["poly_size"], \
        fam["bsk_level"]
    b_bytes = (n * k1 * l * k1 * N + (kn1 - 1) * fam["ksk_level"] * (n + 1)
               + boots * (2 * kn1 + N)) * WORD
    return least_s(r_ops, r_bytes), least_s(r_ops + keyswitch_ops(fam, boots),
                                            b_bytes)
