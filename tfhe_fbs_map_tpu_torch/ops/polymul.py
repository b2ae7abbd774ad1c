"""Negacyclic polynomial helpers in Z_{2^32}[X]/(X^N + 1) (torch).

Counterparts of ``tfhe_fbs_map_tpu.ops.polymul``: the negacyclic matrix,
the exact product :func:`negacyclic_polymul` (any leading batch dims) with
its host numpy copy :func:`np_negacyclic_polymul`, and the monomial
rotation.  On a GPU a gather is cheap, so the matrix and the rotation are
index reads; the gather-free TPU forms (rotation stack by roll doubling,
barrel shifter, one-hot rotation) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

# torus helpers duplicated from tfhe.numeric to keep ops/ leaf-level: the
# tfhe package imports this module, and ``ops`` re-exports it
I64 = torch.int64
MASK32 = (1 << 32) - 1


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int32 congruent mod 2^32."""
    x = x.to(I64)
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)

__all__ = ["negacyclic_matrix", "negacyclic_rotation_stack",
           "negacyclic_polymul", "monomial_rotate", "np_negacyclic_polymul"]


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


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product a·b mod (X^N + 1, 2^32) over matching
    leading batch dims, int32: ``a`` [..., N] (typically small digit
    values), ``b`` [..., N] torus.  Each product a[j]·M[j, t] is wrapped to
    32 bits before the sum over j, so the int64 sum cannot overflow; an
    elementwise multiply and sum, since CUDA has no integer matmul."""
    mat = negacyclic_matrix(b).to(I64)                  # [..., N, N]
    prods = (a.to(I64)[..., :, None] * mat) & MASK32
    return wrap32(prods.sum(-2))


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


def np_negacyclic_polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product mod 2^32 via full convolution (host-side,
    one polynomial each)."""
    n = a.shape[-1]
    conv = np.convolve(np.asarray(a, dtype=np.int64),
                       np.asarray(b, dtype=np.int64))
    out = np.zeros(n, dtype=np.int64)
    out[: len(conv[:n])] = conv[:n]
    out[: len(conv) - n] -= conv[n:]
    return out.astype(np.uint32).astype(np.int32)
