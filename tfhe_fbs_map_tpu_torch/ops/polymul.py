"""Negacyclic polynomial helpers in Z_{2^32}[X]/(X^N + 1) (torch).

Counterparts of ``tfhe_fbs_map_tpu.ops.polymul``.  On a GPU a gather is
cheap, so the negacyclic matrix and the monomial rotation are index reads;
the gather-free TPU forms (rotation stack by roll doubling, barrel
shifter, one-hot rotation) have no counterpart here.
"""

from __future__ import annotations

import torch

from ..tfhe.numeric import I64, wrap32

__all__ = ["negacyclic_matrix", "negacyclic_rotation_stack",
           "monomial_rotate"]


def negacyclic_matrix(poly: torch.Tensor) -> torch.Tensor:
    """[..., N] -> [..., N, N] matrix M with (a ⊛ poly)[t] = Σ_j a[j]·M[j, t].

    M[j, t] = poly[t-j] for t >= j, else -poly[N+t-j] (X^N = -1)."""
    n = poly.shape[-1]
    ar = torch.arange(n, device=poly.device)
    t, j = ar[None, :], ar[:, None]
    idx = (t - j) % n
    neg = t < j
    m = poly.to(I64)[..., idx]
    return wrap32(torch.where(neg, -m, m))


# Row j of the negacyclic matrix is X^j·poly: the same [N, N] stack the JAX
# package builds gather-free.
negacyclic_rotation_stack = negacyclic_matrix


def monomial_rotate(poly: torch.Tensor, amount) -> torch.Tensor:
    """X^amount · poly with amount ∈ [0, 2N), batched.

    ``poly``: [..., N]; ``amount``: broadcastable to ``poly.shape[:-1]``."""
    n = poly.shape[-1]
    amount = torch.as_tensor(amount, device=poly.device).to(I64)[..., None]
    t = torch.arange(n, device=poly.device)
    idx2n = (t - amount) % (2 * n)
    wrap = idx2n >= n
    idx = torch.where(wrap, idx2n - n, idx2n)
    shape = torch.broadcast_shapes(poly.shape, idx.shape)
    gathered = torch.gather(poly.to(I64).expand(shape), -1,
                            idx.expand(shape))
    return wrap32(torch.where(wrap.expand(shape), -gathered, gathered))
