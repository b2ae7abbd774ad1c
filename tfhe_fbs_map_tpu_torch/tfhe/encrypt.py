"""LWE encryption, decryption, encoding and ciphertext lincombs (torch).

The counterpart of ``tfhe_fbs_map_tpu.tfhe.encrypt``: the same wire
convention (a wire value ``v`` is encrypted as ``v * delta`` under the
extracted key) and the same numpy draws in the same order, so equal seeds
give equal ciphertexts.  Dot products with the binary key are elementwise
int64 multiply-and-sum, wrapped to int32: torch has no integer matmul on
CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import TFHEKeys
from .numeric import I64, wrap32
from .params import Q_BITS, TFHEParams

__all__ = ["lwe_encrypt", "lwe_phase", "encode", "decode", "encrypt_values",
           "decrypt_values", "lwe_lincomb"]


def encode(values, params: TFHEParams) -> np.ndarray:
    return (np.asarray(values, dtype=np.int64) * params.delta) \
        .astype(np.uint32).astype(np.int32)


def decode(phases, params: TFHEParams) -> np.ndarray:
    """Nearest-multiple decode of decrypted phases -> values in [0, 2p)."""
    u = np.asarray(phases).astype(np.uint32).astype(np.float64)
    return (np.round(u / params.delta).astype(np.int64)) % (2 * params.p)


def _key_dot(a: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Σ_d a[..., d]·key[d] as int64 (reduced mod 2^32 by the caller)."""
    return (a.to(I64) * key.to(I64)).sum(-1)


def lwe_encrypt(key: torch.Tensor, mus, noise_std: float,
                rng: np.random.Generator) -> torch.Tensor:
    """Encrypt torus values ``mus`` [B] under ``key`` [d] -> [B, d+1] on the
    key's device."""
    mus = np.atleast_1d(np.asarray(mus)).astype(np.uint32).astype(np.int32)
    d = int(key.shape[0])
    batch = mus.shape[0]
    a = rng.integers(0, 1 << Q_BITS, (batch, d), dtype=np.uint32) \
        .astype(np.int32)
    e = np.round(rng.normal(0.0, noise_std, batch)).astype(np.int64) \
        .astype(np.uint32).astype(np.int32)
    a_t = torch.from_numpy(a).to(key.device)
    extra = torch.from_numpy(mus.astype(np.int64) + e).to(key.device)
    b = wrap32(_key_dot(a_t, key) + extra)
    return torch.cat([a_t, b[:, None]], dim=1)


def lwe_phase(key: torch.Tensor, cts: torch.Tensor) -> torch.Tensor:
    """Decrypt to phases: b - <a, s>.  ``cts`` [B, d+1] -> [B] int32."""
    d = int(key.shape[0])
    return wrap32(cts[:, d].to(I64) - _key_dot(cts[:, :d], key))


def encrypt_values(keys: TFHEKeys, values,
                   rng: np.random.Generator) -> torch.Tensor:
    """Encrypt integer wire values under the big (extracted) key."""
    return lwe_encrypt(keys.extracted_key, encode(values, keys.params),
                       keys.params.glwe_noise_std, rng)


def decrypt_values(keys: TFHEKeys, cts: torch.Tensor) -> np.ndarray:
    phases = lwe_phase(keys.extracted_key, cts).cpu().numpy()
    return decode(phases, keys.params)


def lwe_lincomb(cts: torch.Tensor, coefs, const: int,
                params: TFHEParams) -> torch.Tensor:
    """Homomorphic integer lincomb: sum_i coefs[i]*cts[i] + const.

    ``cts`` [T, d+1] ciphertexts of values v_i -> ciphertext of
    ``sum coefs*v + const``."""
    coefs = torch.as_tensor(np.asarray(coefs, dtype=np.int64),
                            device=cts.device)
    out = (coefs[:, None] * cts.to(I64)).sum(0)
    out[-1] += const * params.delta
    return wrap32(out)
