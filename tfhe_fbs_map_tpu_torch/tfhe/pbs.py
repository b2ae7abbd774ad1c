"""Programmable (functional) bootstrap: key switch → blind rotate → extract.

The generic exact path, the counterpart of ``tfhe_fbs_map_tpu.tfhe.pbs``:
bitwise equal to it, and the oracle the fast path and its kernels are held
to.  Ring products go through :func:`~.numeric.exact_matmul` (float64 on
16-bit halves), so this path also runs on a CUDA device, slowly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.polymul import monomial_rotate, negacyclic_matrix
from .keys import TFHEKeys
from .numeric import I32, I64, exact_matmul, gadget_decompose, \
    round_shift_right, wrap32
from .params import Q_BITS, TFHEParams

__all__ = ["build_test_vector", "keyswitch", "modswitch", "blind_rotate",
           "sample_extract", "functional_bootstrap", "external_product"]


def build_test_vector(table, params: TFHEParams,
                      out_delta: int | None = None) -> tuple[np.ndarray, int]:
    """(test polynomial [N] int32, post-rotation body offset).

    The polynomial holds ``H[floor(t*p/N)]`` so that after blind rotation by
    the (half-window pre-offset) phase of a ciphertext encoding ``x`` the
    constant coefficient is ``T[x]*delta - post``.  Tables longer than p use
    the negacyclic half-table modes (X^N = -1).  ``out_delta``: torus units
    per table unit of the output encoding (default ``params.delta``)."""
    p, N = params.p, params.poly_size
    delta = params.delta if out_delta is None else int(out_delta)
    table = list(table)
    tau = len(table)
    assert 1 <= tau <= 2 * p, f"table length {tau} vs fbs size {p}"

    if tau > p:
        c = table[0] + table[p]
        for x in range(tau - p):
            assert table[x] + table[x + p] == c, (
                "table does not satisfy any negacyclic mode "
                f"(len {tau} > p={p}): {table}")
        post = (c * delta) // 2
    else:
        post = 0

    h = np.array([table[min(j, tau - 1)] * delta - post for j in range(p)],
                 dtype=np.int64)
    window = (np.arange(N, dtype=np.int64) * p) // N
    tv = h[window]
    return tv.astype(np.uint32).astype(np.int32), int(post)


def external_product(glwe: torch.Tensor, ggsw: torch.Tensor,
                     params: TFHEParams) -> torch.Tensor:
    """GGSW ⊡ GLWE: [B, k+1, N] x [(k+1)l, k+1, N] -> [B, k+1, N]."""
    l, b = params.bsk_level, params.bsk_base_log
    k1 = params.glwe_dim + 1
    batch, N = glwe.shape[0], params.poly_size
    digits = gadget_decompose(glwe, b, l)             # [B, k+1, N, l]
    digits = digits.movedim(-1, 2).reshape(batch, k1 * l * N)
    mats = negacyclic_matrix(ggsw)                    # [rows, k+1, N, N]
    mats = mats.permute(0, 2, 1, 3).reshape(k1 * l * N, k1 * N)
    return exact_matmul(digits, mats).reshape(batch, k1, N)


def keyswitch(big_cts: torch.Tensor, keys: TFHEKeys) -> torch.Tensor:
    """LWE key switch big (kN) -> small (n): [B, kN+1] -> [B, n+1]."""
    params = keys.params
    kn, batch = params.big_dim, big_cts.shape[0]
    digits = gadget_decompose(big_cts[:, :kn], params.ksk_base_log,
                              params.ksk_level)       # [B, kN, l]
    flat = digits.reshape(batch, kn * params.ksk_level)
    ksk_flat = keys.ksk.reshape(kn * params.ksk_level, params.lwe_dim + 1)
    out = -exact_matmul(flat, ksk_flat).to(I64)
    out[:, params.lwe_dim] += big_cts[:, kn].to(I64)
    return wrap32(out)


def modswitch(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Torus -> Z_{2N} rotation amounts (int64 values in [0, 2N))."""
    log2n1 = params.poly_size.bit_length()            # log2(2N)
    return round_shift_right(x, Q_BITS - log2n1)


def blind_rotate(small_cts: torch.Tensor, test_polys: torch.Tensor,
                 keys: TFHEKeys) -> torch.Tensor:
    """[B, n+1] x [B, N] -> GLWE accumulators [B, k+1, N]: ACC := X^{-b~}·v,
    then n CMux steps ACC += ExtProd(bsk_i, X^{a~_i}·ACC − ACC)."""
    params = keys.params
    n, k, N = params.lwe_dim, params.glwe_dim, params.poly_size
    batch = small_cts.shape[0]
    a_t = modswitch(small_cts[:, :n], params)
    b_t = modswitch(small_cts[:, n], params)
    v_init = monomial_rotate(test_polys, (2 * N - b_t) % (2 * N))
    acc = torch.cat([torch.zeros((batch, k, N), dtype=I32,
                                 device=test_polys.device),
                     v_init[:, None, :]], dim=1)
    for i in range(n):
        rotated = monomial_rotate(acc, a_t[:, i][:, None])
        diff = wrap32(rotated.to(I64) - acc.to(I64))
        acc = wrap32(acc.to(I64)
                     + external_product(diff, keys.bsk[i], params).to(I64))
    return acc


def sample_extract(acc: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Constant coefficient of GLWE -> big LWE: [B, k+1, N] -> [B, kN+1]."""
    k, N = params.glwe_dim, params.poly_size
    batch = acc.shape[0]
    a = acc[:, :k, :].to(I64)
    a_ext = wrap32(torch.cat([a[..., :1], -a[..., 1:].flip(-1)], dim=-1))
    return torch.cat([a_ext.reshape(batch, k * N), acc[:, k, :1]], dim=1)


def add_body(cts: torch.Tensor, x) -> torch.Tensor:
    """Add ``x`` ([B] or a scalar) to the body column, mod 2^32.  A Python
    scalar stays on the host: copying it to the card would block the host
    until the device's queue drains."""
    out = cts.clone()
    x = x.to(I64) if isinstance(x, torch.Tensor) else int(x)
    out[:, -1] = wrap32(cts[:, -1].to(I64) + x)
    return out


def functional_bootstrap(keys: TFHEKeys, big_cts: torch.Tensor,
                         test_polys: torch.Tensor,
                         posts: torch.Tensor) -> torch.Tensor:
    """Batched FBS: [B, kN+1] ciphertexts, per-row test polys [B, N] and
    post-offsets [B] -> fresh [B, kN+1] ciphertexts of the table lookups."""
    params = keys.params
    # the half-window pre-offset centers each value inside its tv window
    small = keyswitch(add_body(big_cts, params.half_window), keys)
    acc = blind_rotate(small, test_polys, keys)
    return add_body(sample_extract(acc, params), posts)
