"""Plain LWE decryption on the 32-bit torus.

A wire value ``v`` is the phase ``v * delta`` plus noise, ``delta`` the
torus step ``round(2^32 / 2p)`` at message precision ``p``; a ciphertext is
``(a_1 .. a_d, b)`` with phase ``b - sum a_i s_i mod 2^32`` under the binary
secret ``s``.  The dot product runs in float64, exact here: each product is
below 2^32 and a few thousand are summed, below 2^53.
"""

from __future__ import annotations

import numpy as np

__all__ = ["delta", "phases", "decode"]

Q = 1 << 32
CHUNK = 1 << 14            # ciphertexts per float64 product


def delta(p: int) -> int:
    return int(round(Q / (2 * p)))


def phases(cts: np.ndarray, key: np.ndarray) -> np.ndarray:
    """``cts`` [..., d+1] (int32 or uint32) under ``key`` [d] in {0, 1} ->
    phases [...] as int64 in [0, 2^32)."""
    d = key.shape[0]
    flat = cts.reshape(-1, d + 1)
    s = key.astype(np.float64)
    out = np.empty(flat.shape[0], dtype=np.int64)
    for i in range(0, flat.shape[0], CHUNK):
        part = flat[i:i + CHUNK].astype(np.uint32)
        dot = (part[:, :d].astype(np.float64) @ s).astype(np.int64)
        out[i:i + CHUNK] = (part[:, d].astype(np.int64) - dot) % Q
    return out.reshape(cts.shape[:-1])


def decode(ph: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Nearest message step of each phase: (value in [0, 2p), noise as a
    share of the half step, signed)."""
    dl = delta(p)
    steps = np.rint(ph / dl).astype(np.int64)
    err = ph - steps * dl
    return steps % (2 * p), err / (dl / 2)
