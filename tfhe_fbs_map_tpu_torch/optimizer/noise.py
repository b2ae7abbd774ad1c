"""TFHE noise-variance model (q = 2^32, binary keys): the jax-free copy of
``tfhe_fbs_map_tpu.optimizer.noise``.

Standard variance formulas for the atomic pattern
``lincomb → keyswitch → modswitch → blind-rotate`` at absolute precision:
the fatal noise limit is ``q/(4p)`` with p = number of plaintext values, not
bits.  Every expression keeps the original's order and ``math.erfc``, so the
floats are bit-identical (``tests/test_torch_optimizer.py``).

All variances are in absolute torus units squared (out of q = 2^32).
"""

from __future__ import annotations

import math

Q = float(1 << 32)


def var_blind_rotate(n: int, k: int, N: int, l: int, base_log: int,
                     glwe_noise_std: float) -> float:
    """Output variance of one blind rotation (fresh bootstrap output)."""
    b = float(1 << base_log)
    beta2 = b ** (2 * l)
    # key-noise term: n CMuxes, each contracting (k+1)*l*N digit products
    key_term = n * l * (k + 1) * N * ((b * b + 2.0) / 12.0) \
        * glwe_noise_std ** 2
    # decomposition rounding term
    round_term = n * (1.0 + k * N) / 2.0 * (Q * Q) / (12.0 * beta2)
    return key_term + round_term


def var_keyswitch(k: int, N: int, l: int, base_log: int,
                  lwe_noise_std: float) -> float:
    kn = k * N
    b = float(1 << base_log)
    key_term = kn * l * ((b * b) / 12.0) * lwe_noise_std ** 2
    round_term = kn * (Q / b ** l) ** 2 / 24.0
    return key_term + round_term


def var_modswitch(n: int, N: int) -> float:
    w = Q / (2.0 * N)
    return (w * w) * (1.0 + n / 2.0) / 12.0


def p_error_atomic(p: int, sq_norm2: float, n: int, k: int, N: int,
                   br_l: int, br_b: int, ks_l: int, ks_b: int,
                   lwe_noise_std: float, glwe_noise_std: float,
                   dropped_limbs: int = 0) -> float:
    """Per-bootstrap error probability of the full atomic pattern.

    The decision happens at blind-rotate window resolution: total input
    noise (amplified bootstrap outputs + keyswitch + modswitch) must stay
    within the half-window q/(4p) — the absolute-precision bound of the
    reference's concrete patch (``fatal_variance_limit_abs``).

    ``dropped_limbs``: BSK limb-drop quantization of the fast-path key
    matrices (ops/blind_rotate.py ``bsk_limbs = 4 - dropped_limbs``); its
    error lives on the bootstrap output wire and is amplified by the
    lincomb like any other wire noise.
    """
    v_wire = (var_blind_rotate(n, k, N, br_l, br_b, glwe_noise_std)
              + var_bsk_quantization(n, k, N, br_l, br_b, dropped_limbs))
    v_total = (sq_norm2 * v_wire
               + var_keyswitch(k, N, ks_l, ks_b, lwe_noise_std)
               + var_modswitch(n, N))
    sigma = math.sqrt(v_total)
    margin = Q / (4.0 * p)
    if sigma == 0:
        return 0.0
    return math.erfc(margin / (sigma * math.sqrt(2.0)))


def var_bsk_quantization(n: int, k: int, N: int, l: int, base_log: int,
                         dropped_limbs: int) -> float:
    """Extra variance from dropping the low ``dropped_limbs`` 8-bit limbs of
    the precomputed bootstrapping-key matrices (ops/blind_rotate.py
    ``bsk_limbs``).

    Per blind-rotate step, each of the (k+1)·l·N digit products picks up a
    balanced error of width 2^(8·drop).  Unlike regular GGSW noise, this
    error sits on the raw key *values* — the error landing in the GGSW
    mask components is multiplied by the secret key at decryption, so the
    per-product variance is amplified by (1 + k·N/2) (k·N mask coefficients
    × E[s²] = 1/2 for binary keys).  Calibrated against measurement:
    predicted variance is within 15% of the measured quantized-vs-exact
    phase error at n ∈ {16, 32}, k=2, N=512, l=2, b=8, and predicts
    p_error ≈ 0.12 at the r1 bench anchor where 63/512 errors were
    observed (PERF.md "3-limb quantized BSK — rejected")."""
    if dropped_limbs == 0:
        return 0.0
    b = float(1 << base_log)
    err_w = float(1 << (8 * dropped_limbs))
    per_product = ((b * b) / 12.0) * (err_w * err_w / 12.0)
    mask_amp = 1.0 + k * N / 2.0
    return n * l * (k + 1) * N * per_product * mask_amp


def p_error_from_var(p: int, v_total: float) -> float:
    """Decode-error probability at the size-p half-window q/(4p)."""
    if v_total <= 0:
        return 0.0
    return math.erfc((Q / (4.0 * p)) / (math.sqrt(v_total) * math.sqrt(2.0)))


def staged_p_errors(p: int, sq_norm1: float, sq_norm2: float, n: int,
                    k1: int, N1: int, bl1: int, bb1: int, kl1: int, kb1: int,
                    k2: int, N2: int, bl2: int, bb2: int, kl2: int, kb2: int,
                    lwe_noise_std: float, glwe1_noise_std: float,
                    glwe2_noise_std: float,
                    wires_from_stage2: bool = True) -> tuple[float, float]:
    """(stage-1, stage-2) error probabilities of one staged size-p node
    (tfhe/staged.py): stage 1 is a size-(p/2) FBS of the re-gridded x_lo
    lincomb, stage 2 a size-8 FBS of z = G + 4*x_hi.

    ``sq_norm1`` / ``sq_norm2``: effective squared norms of the two stage
    lincombs over *wire* ciphertexts (after any scaled-wire-encoding
    reduction; the stage-1 re-grid multiplier 2 and the stage-2 select
    multiplier m are part of the caller's effective norm when wires are
    not pre-scaled).  In the all-staged regime every circuit wire is a
    stage-2 output, so wires carry the stage-2 fresh-bootstrap variance
    (``wires_from_stage2=False`` gives the conservative max over the two
    families).  Stage 2 additionally eats the stage-1 output G at
    multiplier 1.
    """
    v1 = var_blind_rotate(n, k1, N1, bl1, bb1, glwe1_noise_std)
    v2 = var_blind_rotate(n, k2, N2, bl2, bb2, glwe2_noise_std)
    v_wire = v2 if wires_from_stage2 else max(v1, v2)
    vt1 = (sq_norm1 * v_wire
           + var_keyswitch(k1, N1, kl1, kb1, lwe_noise_std)
           + var_modswitch(n, N1))
    vt2 = (v1 + sq_norm2 * v_wire
           + var_keyswitch(k2, N2, kl2, kb2, lwe_noise_std)
           + var_modswitch(n, N2))
    stage1_p = p // 2 if p >= 32 else p
    select_p = 8 if p % 8 == 0 else p // 2
    return (p_error_from_var(stage1_p, vt1),
            p_error_from_var(select_p, vt2))


# 4-sigma default target, as in the reference pipeline
# (concrete-optimizer `_4_SIGMA`).
P_ERROR_4_SIGMA = 1.0 - math.erf(4.0 / math.sqrt(2.0))
