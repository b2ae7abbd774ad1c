"""Fast-path functional bootstrap: int8-limb key switch, modswitch, the fused
blind-rotation kernels, sample extract.

The counterpart of the ``"fused"`` and ``"fused_otf"`` orientations of
``tfhe_fbs_map_tpu.ops.blind_rotate``, bitwise equal to them and to the
generic path of :mod:`..tfhe.pbs`.  The TPU-only conv orientations and the
XLA ``matmul`` scan have no counterpart.

Keys are split into balanced 8-bit limbs (``signed_limbs``); ``bsk_limbs``
< 4 drops the least significant ones (a quantized bootstrapping key).
"""

from __future__ import annotations

import torch

from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I32, I64, gadget_decompose, int8_matmul, \
    signed_limbs, u32, wrap32
from ..tfhe.params import Q_BITS, TFHEParams
from ..tfhe.pbs import add_body, sample_extract
from .fused_blind_rotate import N_LIMBS, blind_rotate_fused, unsupported
from .polymul import negacyclic_matrix

__all__ = ["FastKeys", "prepare_fast_keys", "keyswitch_fast",
           "functional_bootstrap_fast", "fused_key_bytes", "pick_kernel",
           "FUSED_HEADROOM", "KSK_MAX_BASE_LOG"]

LIMB_BITS = 8
# The key switch's gadget digits must fit int8 with their sign.
KSK_MAX_BASE_LOG = 7
# Device memory left free beside the "fused" key matrices when a native run
# takes K2: room for the wire buffer and one level's temporaries.
FUSED_HEADROOM = 4 << 30


class FastKeys:
    """Device-side key material for the fused kernels.

    ``bsk_kernels``: ``"fused"`` [n, L·(k+1)·N, rows·N] int8, K-major: each
    step's matrix is the transpose of the JAX package's [rows·N, L·(k+1)·N],
    since the int8 tensor-core B operand wants the contraction contiguous;
    or ``"fused_otf"`` [n, L·(k+1), rows, 2N] int8, the JAX package's layout.
    ``ksk_matrix``: the key-switch key's limbs as one [kN·l_ks, 4·(n+1)]
    int8 matrix for ``torch._int_mm``; ``ksk_limbs`` views it in the JAX
    layout [4, kN·l_ks, n+1].
    """

    def __init__(self, params: TFHEParams, bsk_kernels: torch.Tensor,
                 ksk_matrix: torch.Tensor, orientation: str):
        self.params = params
        self.bsk_kernels = bsk_kernels
        self.ksk_matrix = ksk_matrix
        self.orientation = orientation

    @property
    def ksk_limbs(self) -> torch.Tensor:
        rows = self.ksk_matrix.shape[0]
        return self.ksk_matrix.reshape(rows, N_LIMBS, -1).permute(1, 0, 2)

    @property
    def device(self) -> torch.device:
        return self.bsk_kernels.device

    def to(self, device) -> "FastKeys":
        """The same key layouts on ``device`` (a copy; ``self`` where they
        already lie there)."""
        if torch.device(device) == self.device:
            return self
        return FastKeys(self.params, self.bsk_kernels.to(device),
                        self.ksk_matrix.to(device), self.orientation)


def fused_key_bytes(params: TFHEParams, bsk_limbs: int = N_LIMBS) -> int:
    """Bytes of the precomputed ``"fused"`` key matrices."""
    k1, N = params.glwe_dim + 1, params.poly_size
    return params.lwe_dim * (k1 * params.bsk_level * N) * bsk_limbs * k1 * N


def pick_kernel(params: TFHEParams, memory: float, bsk_limbs: int = N_LIMBS,
                headroom: float = FUSED_HEADROOM, served: bool = True) -> str:
    """The kernel one native family takes: ``"fused"`` (K2) when its key
    matrices plus ``headroom`` fit ``memory`` bytes (and, with ``served``,
    K2 serves ``params``), else ``"fused_otf"`` (K1).  The runtime CLI's
    ``--orientation auto`` passes the card's free memory, the cost model
    its device profile's, so the model prices the kernel that runs."""
    if served and unsupported(params, otf=False) is not None:
        return "fused_otf"
    if fused_key_bytes(params, bsk_limbs) + headroom <= memory:
        return "fused"
    return "fused_otf"


def _ksk_matrix(keys: TFHEKeys) -> torch.Tensor:
    p = keys.params
    flat = keys.ksk.reshape(p.big_dim * p.ksk_level, p.lwe_dim + 1)
    return signed_limbs(flat, N_LIMBS, LIMB_BITS).transpose(1, 2) \
        .reshape(flat.shape[0], -1).to(torch.int8).contiguous()


def _fused_step(bsk_i: torch.Tensor, params: TFHEParams,
                bsk_limbs: int) -> torch.Tensor:
    """One step's key matrix [L·(k+1)·N, rows·N] int8, K-major: output
    (limb, component, t) limb-major, contraction (row, j) contiguous."""
    k1, N = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    mats = negacyclic_matrix(bsk_i)                      # [r, comp, j, t]
    limbs = signed_limbs(mats, N_LIMBS, LIMB_BITS)[..., N_LIMBS - bsk_limbs:]
    limbs = limbs.permute(4, 1, 3, 0, 2)                 # [L, comp, t, r, j]
    return limbs.reshape(bsk_limbs * k1 * N, rows * N).to(torch.int8)


def prepare_fast_keys(keys: TFHEKeys, orientation: str = "fused",
                      bsk_limbs: int = N_LIMBS) -> FastKeys:
    """Key layouts of the fused kernels, built on the keys' device.

    ``"fused"`` fills one preallocated int8 tensor one step at a time, so
    the int64 temporaries stay at one step's matrices (~150 MB at
    ``aes128_p4``) next to the 10.9 GB result."""
    params = keys.params
    assert orientation in ("fused", "fused_otf"), orientation
    assert params.bsk_base_log <= 8
    assert params.ksk_base_log <= KSK_MAX_BASE_LOG
    assert 1 <= bsk_limbs <= N_LIMBS
    n, k1, N = params.lwe_dim, params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    drop = N_LIMBS - bsk_limbs

    if orientation == "fused_otf":
        # E = [limbs(−poly), limbs(poly)]: row j of the negacyclic matrix is
        # the cyclic window E[N−j : 2N−j], so X^N = −1 lives in E's data
        pos = signed_limbs(keys.bsk, N_LIMBS, LIMB_BITS)   # [n,r,k+1,N,L]
        neg = signed_limbs(wrap32(-keys.bsk.to(I64)), N_LIMBS, LIMB_BITS)
        ext = torch.cat([neg, pos], dim=-2)[..., drop:]
        ext = ext.permute(0, 4, 2, 1, 3)                    # [n,L,k+1,r,2N]
        kern = ext.reshape(n, bsk_limbs * k1, rows, 2 * N) \
            .to(torch.int8).contiguous()
    else:
        kern = torch.empty((n, bsk_limbs * k1 * N, rows * N),
                           dtype=torch.int8, device=keys.device)
        for i in range(n):
            kern[i] = _fused_step(keys.bsk[i], params, bsk_limbs)
    return FastKeys(params, kern, _ksk_matrix(keys), orientation)


def keyswitch_fast(big_cts: torch.Tensor, fast: FastKeys) -> torch.Tensor:
    """Key switch [B, kN+1] -> [B, n+1] as one int8 matmul over all four
    key limbs, limbs recombined with wrapping shifts."""
    params = fast.params
    kn, batch, d = params.big_dim, big_cts.shape[0], params.lwe_dim + 1
    digits = gadget_decompose(big_cts[:, :kn], params.ksk_base_log,
                              params.ksk_level)
    flat = digits.reshape(batch, kn * params.ksk_level).to(torch.int8)
    prods = int8_matmul(flat, fast.ksk_matrix).reshape(batch, N_LIMBS, d) \
        .to(I64)
    # limb weights as Python ints: a tensor of them built on the card would
    # block the host until the device's queue drains
    out = -sum(prods[:, m] * (1 << (LIMB_BITS * m)) for m in range(N_LIMBS))
    out[:, params.lwe_dim] += big_cts[:, kn].to(I64)
    return wrap32(out)


def _modswitch(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Torus -> rotation amounts in [0, 2N), int32."""
    log2n1 = params.poly_size.bit_length()
    u = (u32(x) + (1 << (Q_BITS - log2n1 - 1))) & 0xFFFFFFFF
    return (u >> (Q_BITS - log2n1)).to(I32)


def functional_bootstrap_fast(fast: FastKeys, big_cts: torch.Tensor,
                              test_polys: torch.Tensor,
                              posts: torch.Tensor) -> torch.Tensor:
    """Batched FBS through the fused kernel of ``fast.orientation``;
    semantics identical to :func:`..tfhe.pbs.functional_bootstrap`."""
    params = fast.params
    n, N = params.lwe_dim, params.poly_size
    small = keyswitch_fast(add_body(big_cts, params.half_window), fast)
    a_t = _modswitch(small[:, :n], params)
    b_t = _modswitch(small[:, n], params)
    b_init = ((2 * N - b_t) % (2 * N))[:, None].contiguous()
    a_steps = a_t.t()[:, :, None].contiguous()
    acc = blind_rotate_fused(b_init, a_steps, test_polys.contiguous(),
                             fast.bsk_kernels, params)
    return add_body(sample_extract(acc.permute(1, 0, 2), params), posts)
