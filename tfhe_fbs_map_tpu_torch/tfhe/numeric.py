"""Exact mod-2^32 torus arithmetic on torch tensors.

Conventions (those of ``tfhe_fbs_map_tpu.tfhe.numeric``):

* the canonical ciphertext dtype is ``torch.int32`` (signed view of the
  torus);
* every product, shift and sum is taken in int64 and wrapped back to int32
  by :func:`wrap32`, so no step relies on signed int32 overflow or on a left
  shift of a negative int;
* torch has no logical right shift for uint32 on the CPU, so the unsigned
  view of a torus value is an int64 in ``[0, 2^32)`` (:func:`u32`).

Torch has no int32/int64 matmul on CUDA.  Products of a small-integer
operand with a torus operand go through :func:`exact_matmul` (float64 on
16-bit halves, exact) or :func:`int8_matmul` (``torch._int_mm``).
"""

from __future__ import annotations

import torch

from .params import Q_BITS

I32 = torch.int32
I64 = torch.int64
MASK32 = (1 << Q_BITS) - 1


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor -> int32 congruent mod 2^32."""
    x = x.to(I64)
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(I32)


to_torus = wrap32


def u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned view of a torus tensor: int64 in [0, 2^32)."""
    return x.to(I64) & MASK32


def round_shift_right(x: torch.Tensor, shift: int) -> torch.Tensor:
    """round(x / 2^shift) of the uint32 view, as int64 in [0, 2^(32-shift)).

    The add wraps mod 2^32 as the uint32 add of the JAX version does."""
    u = u32(x)
    if shift == 0:
        return u
    return ((u + (1 << (shift - 1))) & MASK32) >> shift


def gadget_decompose(x: torch.Tensor, base_log: int,
                     levels: int) -> torch.Tensor:
    """Balanced signed gadget digits ``x.shape + (levels,)`` int32, most
    significant level first, each in ``[-B/2, B/2)``."""
    b, l = base_log, levels
    assert b * l <= Q_BITS
    closest = round_shift_right(x, Q_BITS - b * l)
    half, mask = 1 << (b - 1), (1 << b) - 1
    digits = []
    for _ in range(l):                  # least-significant level first
        d = closest & mask
        closest = closest >> b
        carry = (d >= half).to(I64)
        digits.append(d - (carry << b))
        closest = closest + carry
    return torch.stack(digits[::-1], dim=-1).to(I32)


def gadget_recompose(digits: torch.Tensor, base_log: int) -> torch.Tensor:
    """Inverse of :func:`gadget_decompose` (up to its rounding)."""
    acc = torch.zeros(digits.shape[:-1], dtype=I64, device=digits.device)
    for i in range(digits.shape[-1]):
        acc = acc + digits[..., i].to(I64) * (1 << (Q_BITS - base_log * (i + 1)))
    return wrap32(acc)


def signed_limbs(x: torch.Tensor, n_limbs: int = 4,
                 limb_bits: int = 8) -> torch.Tensor:
    """Balanced base-2^limb_bits limbs ``x.shape + (n_limbs,)`` int32, least
    significant first, with ``sum_i limb_i * 2^(b*i) == x (mod 2^32)``."""
    b = limb_bits
    u = u32(x)
    half, mask = 1 << (b - 1), (1 << b) - 1
    limbs = []
    for _ in range(n_limbs):
        d = u & mask
        u = u >> b
        carry = (d >= half).to(I64)
        limbs.append(d - (carry << b))
        u = u + carry
    return torch.stack(limbs, dim=-1).to(I32)


def exact_matmul(small: torch.Tensor, torus: torch.Tensor) -> torch.Tensor:
    """``small @ torus`` mod 2^32 as int32, on any device.

    ``torus`` is split into a 16-bit low half and a signed high half; each
    half goes through one float64 matmul.  Exact while
    ``K · max|small| · 2^16 < 2^53`` (K the contraction length), which every
    caller's gadget digits satisfy by orders of magnitude."""
    t = torus.to(I64)
    lo = t & 0xFFFF
    hi = (t - lo) >> 16
    s = small.to(torch.float64)
    out_lo = (s @ lo.to(torch.float64)).to(I64)
    out_hi = (s @ hi.to(torch.float64)).to(I64)
    return wrap32(out_lo + out_hi * (1 << 16))


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ int8 [K, N] -> int32 [M, N] through ``torch._int_mm``.

    ``a @ b`` on int8 tensors returns int8 and wraps, hence ``_int_mm``.  Its
    CUDA version wants M > 16 and K, N multiples of 8: the operands are
    zero-padded to that and the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m, :n]


def int8_matmul_nt(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] @ ``b_t.T`` -> int32 [M, N], ``b_t`` a row-major [N, K].

    ``b_t.t()`` is the column-major [K, N] operand cuBLASLt's int8 GEMM
    takes as it lies (the "TN" layout), so ``_int_mm`` gets that view and
    ``b_t`` is never copied, where :func:`int8_matmul` would make it
    contiguous.  K and N must be multiples of 8; ``a`` is zero-padded to
    17 rows where it has fewer."""
    m, k = a.shape
    n = b_t.shape[0]
    if k % 8 or n % 8 or b_t.stride(1) != 1:
        raise ValueError(f"int8_matmul_nt: want K ({k}) and N ({n}) "
                         f"multiples of 8 and a row-major b_t, got strides "
                         f"{b_t.stride()}")
    if m < 17:
        a = torch.nn.functional.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), b_t.t())[:m]
