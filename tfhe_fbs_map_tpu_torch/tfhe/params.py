"""TFHE parameter sets (jax-free copy of ``tfhe_fbs_map_tpu.tfhe.params``).

The ciphertext modulus is fixed to ``q = 2**32``: torus elements are int32
values and every add/mul is taken mod 2^32.  ``tests/test_torch_cli.py``
holds the shared sets equal to the JAX package's and the pinned presets
equal to what the JAX parameter optimizer and ``bench.py`` pick.

``PRESETS`` (one family) and ``STAGED_PRESETS`` (two staged families)
are pins: the runtime CLI takes a preset name (``--params``) in place of
the parameter optimizer's pick (``..optimizer``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

Q_BITS = 32
Q = 1 << Q_BITS


def min_noise_std_rel(n: int) -> float:
    """Minimal relative noise std for ~128-bit security at LWE dimension n."""
    return max(2.0 ** (-0.0245 * n), 2.0 ** (-31))


@dataclass(frozen=True)
class TFHEParams:
    """All sizes for one functional-bootstrap configuration."""

    p: int                  # plaintext divisions (FBS size / precision)
    lwe_dim: int            # n  — small LWE dimension (blind-rotate length)
    glwe_dim: int           # k
    poly_size: int          # N  — power of two
    bsk_level: int          # gadget levels of the bootstrapping key
    bsk_base_log: int       # log2 of the bootstrapping gadget base
    ksk_level: int          # gadget levels of the key-switch key
    ksk_base_log: int       # log2 of the key-switch gadget base
    lwe_noise_std: float    # absolute std (torus units out of q) of small key
    glwe_noise_std: float   # absolute std of GLWE encryptions

    @property
    def big_dim(self) -> int:
        """Dimension of the sample-extracted (wire-level) LWE key."""
        return self.glwe_dim * self.poly_size

    @property
    def delta(self) -> int:
        """Plaintext scaling: one message step on the torus (q / 2p)."""
        return int(round(Q / (2 * self.p)))

    @property
    def half_window(self) -> int:
        """Decision margin: the max |noise| decodable without error."""
        return self.delta // 2

    def with_p(self, p: int) -> "TFHEParams":
        return replace(self, p=p)


TEST_PARAMS = TFHEParams(
    p=4, lwe_dim=16, glwe_dim=1, poly_size=256,
    bsk_level=3, bsk_base_log=7, ksk_level=4, ksk_base_log=4,
    lwe_noise_std=2.0 ** 7, glwe_noise_std=2.0 ** 4,
)

DEFAULT_PARAMS = TFHEParams(
    p=4, lwe_dim=630, glwe_dim=1, poly_size=1024,
    bsk_level=3, bsk_base_log=7, ksk_level=5, ksk_base_log=3,
    lwe_noise_std=2.0 ** (Q_BITS - 15.0), glwe_noise_std=2.0 ** (Q_BITS - 25.0),
)

FAST_PARAMS = TFHEParams(
    p=4, lwe_dim=630, glwe_dim=2, poly_size=512,
    bsk_level=2, bsk_base_log=8, ksk_level=5, ksk_base_log=3,
    lwe_noise_std=2.0 ** (Q_BITS - 15.0), glwe_noise_std=2.0 ** (Q_BITS - 25.0),
)


def _curve(p, n, k, N, bl, bb, kl, kb) -> TFHEParams:
    """A set whose noise sits on the security curve at its dimensions."""
    return TFHEParams(p=p, lwe_dim=n, glwe_dim=k, poly_size=N,
                      bsk_level=bl, bsk_base_log=bb, ksk_level=kl,
                      ksk_base_log=kb,
                      lwe_noise_std=min_noise_std_rel(n) * 2.0 ** 32,
                      glwe_noise_std=min_noise_std_rel(k * N) * 2.0 ** 32)


# name -> (params, per-bootstrap error probability the JAX optimizer
# reports for it, or None where none was recorded)
PRESETS: dict[str, tuple[TFHEParams, float | None]] = {
    "test": (TEST_PARAMS, None),
    # bench.py's anchor for the s8 matmul / fused paths
    "anchor": (_curve(4, 546, 2, 512, 2, 8, 4, 3), None),
    # bench.py --preset p8 / p16, and --preset p32 --native-p32 (one N=2048
    # bootstrap a lookup)
    "p8": (_curve(8, 642, 2, 512, 2, 8, 6, 2), None),
    "p16": (_curve(16, 642, 1, 1024, 3, 6, 6, 2), None),
    "p32": (_curve(32, 706, 1, 2048, 3, 7, 7, 2), None),
    # optimize(4, 6, max_p_error=1e-7): mapped AES-128 (norm2_linprod 6)
    "aes128_p4": (_curve(4, 578, 2, 512, 2, 8, 6, 2), 4.332587781355008e-08),
}


class StagedPreset(NamedTuple):
    """A staged two-family parameter pick (:mod:`.staged`): the wire-level
    FBS size ``p``, the stage-1 / catch-all family ``fam1``, the select
    family ``fam2``, and the per-bootstrap error probability the JAX
    optimizer reports for the pair (None where none was recorded)."""
    p: int
    fam1: TFHEParams
    fam2: TFHEParams
    p_error: float | None


# Tiny insecure families (shared kN = 256, n = 16) for CPU runs.
_STAGED_TEST_FAMS = tuple(
    TFHEParams(p=p, lwe_dim=16, glwe_dim=k, poly_size=N, bsk_level=3,
               bsk_base_log=7, ksk_level=4, ksk_base_log=4,
               lwe_noise_std=2.0, glwe_noise_std=2.0)
    for p, k, N in ((16, 1, 256), (8, 2, 128)))

STAGED_PRESETS: dict[str, StagedPreset] = {
    # optimize_staged(10, 27, 25, weight1=8754, weight2=93,
    # wires_from_stage2=False, max_p_error=1e-7): the keyless staged probe
    # of the Kreyvium-1152 program
    # (outputs/generated/kreyvium_stream_v1_10_search.lbf)
    "kreyvium_p10_staged": StagedPreset(
        10, _curve(10, 642, 1, 1024, 4, 5, 6, 2),
        _curve(5, 642, 2, 512, 4, 5, 3, 4), 9.420547894708717e-08),
    # optimize_staged(32, 4, 2, max_p_error=1e-6): bench.py --preset p32
    "p32_staged": StagedPreset(
        32, _curve(16, 674, 1, 1024, 3, 6, 7, 2),
        _curve(8, 674, 2, 512, 4, 5, 3, 4), 8.215312943506652e-07),
    "staged_test": StagedPreset(32, *_STAGED_TEST_FAMS, None),
}
