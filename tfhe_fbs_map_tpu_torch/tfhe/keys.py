"""Key generation: LWE/GLWE secret keys, bootstrapping and key-switch keys.

The counterpart of ``tfhe_fbs_map_tpu.tfhe.keys``, bitwise equal to it for
the same parameters and seed: masks and noise are drawn host-side from a
seeded numpy ``Generator`` in the same order, and the ring products are
exact mod 2^32.  Layouts are the JAX package's:

* bootstrapping key ``[n, (k+1)*l, k+1, N]`` int32, rows ``(component c,
  level)`` with level minor;
* key-switch key ``[kN, l_ks, n+1]`` int32.

:func:`keys_from_numpy` (:func:`staged_keys_from_numpy` for two staged
families) carries key material made by the JAX package (as numpy arrays)
into the port, and :func:`save_keys`/:func:`load_keys` use
the JAX package's ``.npz`` format, so a key file moves between the two.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.polymul import negacyclic_rotation_stack
from .numeric import I32, I64, wrap32
from .params import Q_BITS, TFHEParams

__all__ = ["TFHEKeys", "generate_keys", "keys_from_numpy",
           "staged_keys_from_numpy", "save_keys", "load_keys"]


def _noise(rng: np.random.Generator, std: float, shape) -> np.ndarray:
    return np.round(rng.normal(0.0, std, shape)).astype(np.int64) \
        .astype(np.uint32).astype(np.int32)


def _uniform_torus(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << Q_BITS, shape, dtype=np.uint32) \
        .astype(np.int32)


@dataclass
class TFHEKeys:
    params: TFHEParams
    lwe_key: torch.Tensor        # [n] int32 in {0,1}
    glwe_key: torch.Tensor       # [k, N] int32 in {0,1}
    bsk: torch.Tensor            # [n, (k+1)*l, k+1, N] int32
    ksk: torch.Tensor            # [kN, l_ks, n+1] int32

    @property
    def device(self) -> torch.device:
        return self.bsk.device

    @property
    def extracted_key(self) -> torch.Tensor:
        """Big LWE key [kN]: the GLWE key coefficients in extract order."""
        return self.glwe_key.reshape(-1)

    def to(self, device) -> "TFHEKeys":
        """The same key material on ``device``: a copy, never new keys
        (``self`` where it already lies there)."""
        if torch.device(device) == self.device:
            return self
        return dataclasses.replace(
            self, lwe_key=self.lwe_key.to(device),
            glwe_key=self.glwe_key.to(device), bsk=self.bsk.to(device),
            ksk=self.ksk.to(device))


def keys_from_numpy(params: TFHEParams, lwe_key, glwe_key, bsk, ksk, *,
                    device) -> TFHEKeys:
    """Key material as numpy arrays (e.g. ``np.asarray`` of a JAX key set)
    -> a :class:`TFHEKeys` on ``device``."""
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
    return TFHEKeys(params=params, lwe_key=t(lwe_key), glwe_key=t(glwe_key),
                    bsk=t(bsk), ksk=t(ksk))


def staged_keys_from_numpy(p: int, keys1_arrays, keys2_arrays, *, device):
    """Two families' key material, each ``(params, lwe_key, glwe_key, bsk,
    ksk)`` as :func:`keys_from_numpy` takes it (e.g. from a JAX
    ``StagedKeys``) -> a :class:`.staged.StagedKeys` on ``device``."""
    from .staged import StagedKeys
    return StagedKeys(p=p, keys1=keys_from_numpy(*keys1_arrays, device=device),
                      keys2=keys_from_numpy(*keys2_arrays, device=device))


def save_keys(path: str, keys: TFHEKeys) -> None:
    """Serialize a key set (``.npz``, the JAX package's format)."""
    np.savez_compressed(
        path,
        params=np.array([list(dataclasses.asdict(keys.params).values())],
                        dtype=object),
        param_names=np.array(list(dataclasses.asdict(keys.params).keys())),
        lwe_key=keys.lwe_key.cpu().numpy(),
        glwe_key=keys.glwe_key.cpu().numpy(),
        bsk=keys.bsk.cpu().numpy(),
        ksk=keys.ksk.cpu().numpy())


def load_keys(path: str, *, device) -> TFHEKeys:
    with np.load(path, allow_pickle=True) as z:
        kw = dict(zip(z["param_names"].tolist(), z["params"][0]))
        return keys_from_numpy(TFHEParams(**kw), z["lwe_key"], z["glwe_key"],
                               z["bsk"], z["ksk"], device=device)


def _binary_dot(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``x @ key`` mod 2^32 for a {0,1} (or ±1) right operand, as int32.

    float64 is exact here: each term is below 2^31 in magnitude and at most
    a few thousand are summed, so every partial sum stays below 2^53."""
    return wrap32((x.to(torch.float64) @ key.to(torch.float64)).to(I64))


def generate_keys(params: TFHEParams, seed: int = 0, *, device,
                  rng: np.random.Generator | None = None,
                  lwe_key: np.ndarray | None = None,
                  glwe_key: np.ndarray | None = None) -> TFHEKeys:
    """Keys on ``device``, drawn from ``rng`` (default
    ``np.random.default_rng(seed)``) in the JAX package's order.

    ``lwe_key`` / ``glwe_key``: optional binary secrets (numpy) used instead
    of drawing them; the staged bootstrap (:mod:`.staged`) builds two
    families over one master GLWE secret and one small key this way."""
    rng = np.random.default_rng(seed) if rng is None else rng
    n, k, N = params.lwe_dim, params.glwe_dim, params.poly_size
    l_b, b_b = params.bsk_level, params.bsk_base_log
    l_k, b_k = params.ksk_level, params.ksk_base_log

    lwe_key_np = (rng.integers(0, 2, n, dtype=np.int64).astype(np.int32)
                  if lwe_key is None else
                  np.asarray(lwe_key, dtype=np.int32))
    glwe_key_np = (rng.integers(0, 2, (k, N), dtype=np.int64).astype(np.int32)
                   if glwe_key is None else
                   np.asarray(glwe_key, dtype=np.int32).reshape(k, N))
    if lwe_key_np.shape != (n,):
        raise ValueError(f"lwe_key has shape {lwe_key_np.shape}, want ({n},)")
    lwe_key = torch.from_numpy(lwe_key_np).to(device)
    glwe_key = torch.from_numpy(glwe_key_np).to(device)
    key_mats = negacyclic_rotation_stack(glwe_key)          # [k, N, N]

    # --- bootstrapping key: GGSW(s_i) under the GLWE key ------------------
    rows = (k + 1) * l_b
    a = torch.from_numpy(_uniform_torus(rng, (n, rows, k, N))).to(device)
    e = torch.from_numpy(_noise(rng, params.glwe_noise_std, (n, rows, N)))
    body = e.to(device).to(I64)
    for c in range(k):
        body = body + _binary_dot(a[:, :, c, :], key_mats[c]).to(I64)

    msg = np.zeros((n, rows, k + 1, N), dtype=np.int64)
    for c in range(k + 1):
        for lev in range(l_b):
            g = 1 << (Q_BITS - b_b * (lev + 1))
            msg[:, c * l_b + lev, c, 0] = lwe_key_np.astype(np.int64) * g
    msg = torch.from_numpy(msg).to(device)
    bsk = wrap32(torch.cat([a.to(I64), body[:, :, None, :]], dim=2) + msg)

    # --- key-switch key: LWE(s_big[t] * g_lev) under the small key --------
    big_np = glwe_key_np.reshape(-1)                         # [kN]
    kn = big_np.shape[0]
    ks_a = torch.from_numpy(_uniform_torus(rng, (kn, l_k, n))).to(device)
    ks_e = _noise(rng, params.lwe_noise_std, (kn, l_k)).astype(np.int64)
    ks_gadget = np.array(
        [1 << (Q_BITS - b_k * (lev + 1)) for lev in range(l_k)],
        dtype=np.int64)
    ks_msg = torch.from_numpy(
        big_np.astype(np.int64)[:, None] * ks_gadget[None, :] + ks_e) \
        .to(device)
    ks_b = wrap32(_binary_dot(ks_a, lwe_key).to(I64) + ks_msg)
    ksk = torch.cat([ks_a, ks_b[:, :, None]], dim=2)

    return TFHEKeys(params=params, lwe_key=lwe_key, glwe_key=glwe_key,
                    bsk=bsk.to(I32), ksk=ksk)
