"""Fast-path functional bootstrap: int8-limb key switch, modswitch, the
blind rotation, sample extract.

The counterpart of every orientation of ``tfhe_fbs_map_tpu.ops.blind_rotate``,
bitwise equal to it and to the generic path of :mod:`..tfhe.pbs`:

* ``"fused"`` and ``"fused_otf"`` run the n CMux steps in one launch of
  the fused kernels (:mod:`.fused_blind_rotate`);
* ``"matmul"`` is the JAX package's XLA scan: each step one int8 product
  ``torch._int_mm`` of the step's gadget digits [B, rows·N] and the same
  key matrix K2 streams, then the limbs shift-added, with the rotation and
  the digits plain PyTorch around it (:func:`cmux_partial`).  Its key
  contraction can be split over tp positions (:func:`shard_contraction`,
  :func:`bootstrap_matmul`);
* the conv orientations ``"keys_rhs"``, ``"keys_lhs"`` and
  ``"keys_lhs_bf16"`` hold JAX's compact conv keys, bitwise its tensors,
  and run the same scan: each step builds its key's Hankel windows once
  as the B operand of one product (:func:`conv_step_matrix`), ``torch._int_mm``
  for the int8 layouts and, for the bf16 one, ``torch.mm`` with fp32
  output over two sub-digit operands, exact while every sum stays below
  2^24 (:func:`conv_product`).  On the CPU the bf16 product runs in
  float64, which gives the same integers.

Keys are split into balanced 8-bit limbs (``signed_limbs``); ``bsk_limbs``
< 4 drops the least significant ones (a quantized bootstrapping key) in
the fused and matmul layouts; the conv layouts keep all four, as JAX's do.
"""

from __future__ import annotations

import torch

from ..tfhe.keys import TFHEKeys
from ..tfhe.numeric import I32, I64, gadget_decompose, int8_matmul, \
    int8_matmul_nt, signed_limbs, u32, wrap32
from ..tfhe.params import Q_BITS, TFHEParams
from ..tfhe.pbs import add_body, sample_extract
from ..utils import profiling
from .fused_blind_rotate import N_LIMBS, blind_rotate_fused, \
    decompose_digits, hankel_table
from .polymul import monomial_rotate, negacyclic_matrix

__all__ = ["FastKeys", "prepare_fast_keys", "keyswitch_fast",
           "functional_bootstrap_fast", "fused_key_bytes",
           "shard_contraction", "bootstrap_matmul", "cmux_partial",
           "rotate", "step_digits", "key_product", "external_product_conv",
           "conv_unsupported", "conv_step_matrix", "conv_product",
           "ORIENTATIONS", "CONV_ORIENTATIONS", "FUSED_HEADROOM",
           "KSK_MAX_BASE_LOG", "CONV_MAX_BASE_LOG"]

CONV_ORIENTATIONS = ("keys_rhs", "keys_lhs", "keys_lhs_bf16")
ORIENTATIONS = ("fused", "fused_otf", "matmul") + CONV_ORIENTATIONS

LIMB_BITS = 8
# The key switch's gadget digits must fit int8 with their sign.
KSK_MAX_BASE_LOG = 7
# The conv orientations negate the bootstrap's digits ([-d, d]); they fit
# int8 up to base 2^7 (JAX blind_rotate.py:82-85).
CONV_MAX_BASE_LOG = 7
# keys_lhs_bf16 accumulates in fp32, exact while every sum stays below 2^24:
# a sub-digit |d_lo| <= 8 times a limb |x| <= 128, summed over rows·N.
BF16_EXACT = 1 << 24
BF16_TERM = 8 * 128
# Device memory left free beside the "fused" key matrices when a native run
# takes K2: room for the wire buffer and one level's temporaries.
FUSED_HEADROOM = 4 << 30


class FastKeys:
    """Device-side key material of the fast bootstrap.

    ``bsk_kernels``: ``"fused"`` and ``"matmul"`` [n, L·(k+1)·N, rows·N]
    int8, K-major: each step's matrix is the transpose of the JAX
    package's [rows·N, L·(k+1)·N], since the int8 tensor-core B operand
    wants the contraction contiguous; ``"fused_otf"`` [n, L·(k+1), rows,
    2N] int8, the JAX package's layout; or a conv orientation's JAX
    layout, component-major in the second axis: ``"keys_rhs"`` [n,
    (k+1)·4, rows, N] int8, the reversed limbs of each key polynomial K,
    ``"keys_lhs"`` [n, (k+1)·4, rows, 2N] int8, the limbs of its extension
    [−K, K], and ``"keys_lhs_bf16"`` the same in bfloat16.
    ``ksk_matrix``: the key-switch key's limbs as one [kN·l_ks, 4·(n+1)]
    int8 matrix for ``torch._int_mm``; ``ksk_limbs`` views it in the JAX
    layout [4, kN·l_ks, n+1].

    ``shard`` (index, tp): the slice of the key contraction this copy holds
    (:func:`shard_contraction`); (0, 1) is the whole of it.  ``route``:
    the route of every ``"fused_otf"`` launch at N ≥ 256 through these
    keys (``fused_blind_rotate.K1_ROUTES``; None: the one the cost model
    prices lower at each launch); the cost model's launch choice reads it
    (``optimizer.runtime_model.launch_choice``).  :meth:`hankel`: the ring
    kernel's table of ``"fused_otf"``'s keys, built at its first ring
    launch and kept.
    """

    def __init__(self, params: TFHEParams, bsk_kernels: torch.Tensor,
                 ksk_matrix: torch.Tensor, orientation: str,
                 shard: tuple[int, int] = (0, 1), route: str | None = None):
        self.params = params
        self.bsk_kernels = bsk_kernels
        self.ksk_matrix = ksk_matrix
        self.orientation = orientation
        self.shard = shard
        self.route = route
        self._hankel = None

    def hankel(self) -> torch.Tensor:
        """The table of H blocks K1's ring kernel reads
        (:func:`.fused_blind_rotate.hankel_table`), built at the first call
        and kept: a key's launches never rebuild it, and a key none of
        whose launches takes the ring never builds it."""
        if self._hankel is None:
            self._hankel = hankel_table(self.bsk_kernels)
        return self._hankel

    @property
    def ksk_limbs(self) -> torch.Tensor:
        rows = self.ksk_matrix.shape[0]
        return self.ksk_matrix.reshape(rows, N_LIMBS, -1).permute(1, 0, 2)

    @property
    def device(self) -> torch.device:
        return self.bsk_kernels.device

    @property
    def limbs(self) -> int:
        """The bootstrapping key's limbs: ``bsk_limbs`` of the fused and
        matmul layouts, 4 in the conv ones."""
        k1 = self.params.glwe_dim + 1
        if self.orientation in ("fused", "matmul"):
            k1 *= self.params.poly_size
        return self.bsk_kernels.shape[1] // k1

    def to(self, device) -> "FastKeys":
        """The same key layouts on ``device`` (a copy; ``self`` where they
        already lie there)."""
        if torch.device(device) == self.device:
            return self
        return FastKeys(self.params, self.bsk_kernels.to(device),
                        self.ksk_matrix.to(device), self.orientation,
                        self.shard, self.route)


def fused_key_bytes(params: TFHEParams, bsk_limbs: int = N_LIMBS) -> int:
    """Bytes of the precomputed key matrices of ``"fused"`` and
    ``"matmul"``."""
    k1, N = params.glwe_dim + 1, params.poly_size
    return params.lwe_dim * (k1 * params.bsk_level * N) * bsk_limbs * k1 * N


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


def conv_unsupported(params: TFHEParams, orientation: str,
                     device: torch.device | None = None) -> str | None:
    """Why the conv ``orientation`` cannot run ``params`` (on ``device``),
    or None: the negated digits must fit int8 (``bsk_base_log`` ≤ 7, JAX's
    rule), each step's product takes N a multiple of 8 (``torch._int_mm``'s
    shapes), and ``"keys_lhs_bf16"`` is exact only while rows·N·8·128 <
    2^24 and, on CUDA, needs a bf16 product with fp32 output
    (``torch.mm(..., out_dtype=torch.float32)``, ``aten::mm.dtype``)."""
    rows = (params.glwe_dim + 1) * params.bsk_level
    N = params.poly_size
    if params.bsk_base_log > CONV_MAX_BASE_LOG:
        return (f"the conv orientations negate the bootstrap's digits, "
                f"which fit int8 up to bsk_base_log {CONV_MAX_BASE_LOG}, not "
                f"{params.bsk_base_log}")
    if N % 8:
        return f"N={N} is not a multiple of 8"
    if orientation == "keys_lhs_bf16":
        if rows * N * BF16_TERM >= BF16_EXACT:
            return (f"rows·N·8·128 = {rows * N * BF16_TERM} reaches 2^24, "
                    f"where fp32 sums of the bf16 products stop being exact")
        if device is not None and torch.device(device).type == "cuda":
            return _bf16_mm_missing(torch.device(device))
    return None


def _bf16_mm_missing(device: torch.device) -> str | None:
    """None when ``torch.mm`` multiplies bf16 operands into fp32 on
    ``device`` (one product of two 8×8 matrices), else what is missing."""
    a = torch.ones((8, 8), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError) as e:
        return (f"this PyTorch ({torch.__version__}) has no bf16 product "
                f"with fp32 output on {device} (torch.mm(..., "
                f"out_dtype=torch.float32), aten::mm.dtype): {e}")
    return None


def _conv_keys(bsk: torch.Tensor, orientation: str) -> torch.Tensor:
    """JAX's conv key layouts (``blind_rotate.py:181-198``) of ``bsk`` [n,
    rows, k+1, N]: component-major [n, (k+1)·4, rows, N or 2N]."""
    n, rows, k1, N = bsk.shape
    if orientation == "keys_rhs":
        limbs = signed_limbs(bsk, N_LIMBS, LIMB_BITS)       # [n,r,k+1,N,L]
        kern = limbs.permute(0, 2, 4, 1, 3).flip(-1)         # reversed
    else:
        # the extension [−K, K] in int64 first: an int8 limb of −128 has no
        # negation, and the split is linear position by position
        b64 = bsk.to(I64)
        limbs = signed_limbs(torch.cat([-b64, b64], dim=-1), N_LIMBS,
                             LIMB_BITS)                      # [n,r,k+1,2N,L]
        kern = limbs.permute(0, 2, 4, 1, 3)                  # [n,k+1,L,r,2N]
    dtype = torch.bfloat16 if orientation == "keys_lhs_bf16" else torch.int8
    return kern.reshape(n, k1 * N_LIMBS, rows, -1).to(dtype).contiguous()


def prepare_fast_keys(keys: TFHEKeys, orientation: str = "fused",
                      bsk_limbs: int = N_LIMBS) -> FastKeys:
    """Key layouts of ``orientation``, built on the keys' device.

    ``"fused"`` and ``"matmul"`` share one layout (as in the JAX package),
    filled into one preallocated int8 tensor one step at a time, so the
    int64 temporaries stay at one step's matrices (~150 MB at
    ``aes128_p4``) next to the 10.9 GB result.  The conv orientations keep
    all four limbs and raise ValueError where :func:`conv_unsupported`
    says they cannot run."""
    params = keys.params
    assert orientation in ORIENTATIONS, orientation
    if orientation in CONV_ORIENTATIONS:
        if bsk_limbs != N_LIMBS:
            raise ValueError(f"--orientation {orientation} keeps all "
                             f"{N_LIMBS} key limbs (JAX's conv layouts), "
                             f"not {bsk_limbs}")
        why = conv_unsupported(params, orientation, keys.device)
        if why is not None:
            raise ValueError(f"--orientation {orientation}: {why}")
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
    elif orientation in CONV_ORIENTATIONS:
        kern = _conv_keys(keys.bsk, orientation)
    else:
        kern = torch.empty((n, bsk_limbs * k1 * N, rows * N),
                           dtype=torch.int8, device=keys.device)
        for i in range(n):
            kern[i] = _fused_step(keys.bsk[i], params, bsk_limbs)
    return FastKeys(params, kern, _ksk_matrix(keys), orientation)


def _slice_cols(x: torch.Tensor, shard: tuple[int, int],
                width: int) -> torch.Tensor:
    """Columns [index·width, (index+1)·width) of ``x`` [B, C], the ones past
    C zeros: the operand of a contraction slice (:func:`shard_contraction`).
    The whole of ``x`` where it is not sharded."""
    index, tp = shard
    if tp == 1 and width == x.shape[1]:
        return x
    lo = index * width
    part = x[:, lo:lo + width]
    if part.shape[1] < width:
        part = torch.nn.functional.pad(part, (0, width - part.shape[1]))
    return part.contiguous()


def keyswitch_partial(big_cts: torch.Tensor, fast: FastKeys) -> torch.Tensor:
    """The key switch's product over ``fast``'s rows of the key-switch key
    (all of them unless ``fast`` is a contraction slice): [B, kN+1] ->
    Σ_rows digit·key [B, n+1] int32, as one int8 matmul over all four key
    limbs, limbs recombined mod 2^32.  Linear in the rows, so the slices'
    partials add up to the whole product."""
    params = fast.params
    kn, batch, d = params.big_dim, big_cts.shape[0], params.lwe_dim + 1
    digits = gadget_decompose(big_cts[:, :kn], params.ksk_base_log,
                              params.ksk_level)
    flat = digits.reshape(batch, kn * params.ksk_level).to(torch.int8)
    flat = _slice_cols(flat, fast.shard, fast.ksk_matrix.shape[0])
    prods = int8_matmul(flat, fast.ksk_matrix).reshape(batch, N_LIMBS, d) \
        .to(I64)
    # limb weights as Python ints: a tensor of them built on the card would
    # block the host until the device's queue drains
    return wrap32(sum(prods[:, m] * (1 << (LIMB_BITS * m))
                      for m in range(N_LIMBS)))


def _keyswitch_finish(product: torch.Tensor, big_cts: torch.Tensor,
                      params: TFHEParams) -> torch.Tensor:
    """The switched ciphertext [B, n+1] from the whole product: its
    negation, plus the body."""
    out = -product.to(I64)
    out[:, params.lwe_dim] += big_cts[:, params.big_dim].to(I64)
    return wrap32(out)


def keyswitch_fast(big_cts: torch.Tensor, fast: FastKeys) -> torch.Tensor:
    """Key switch [B, kN+1] -> [B, n+1] as one int8 matmul over all four
    key limbs, limbs recombined with wrapping shifts."""
    return _keyswitch_finish(keyswitch_partial(big_cts, fast), big_cts,
                             fast.params)


def _modswitch(x: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Torus -> rotation amounts in [0, 2N), int32."""
    log2n1 = params.poly_size.bit_length()
    u = (u32(x) + (1 << (Q_BITS - log2n1 - 1))) & 0xFFFFFFFF
    return (u >> (Q_BITS - log2n1)).to(I32)


# ----------------------------------------------------------- matmul

def _contraction_width(params: TFHEParams, tp: int) -> int:
    """Columns of each of ``tp`` slices of the contraction rows·N: a
    multiple of 8 (``torch._int_mm``'s), the last slice zero-padded."""
    t = (params.glwe_dim + 1) * params.bsk_level * params.poly_size
    return -(-t // (8 * tp)) * 8


def shard_contraction(fast: FastKeys, index: int, tp: int) -> FastKeys:
    """Slice ``index`` of ``tp`` of a ``"matmul"`` key's contractions, as
    the JAX package shards them over its mesh's tp axis: [n, D, T/tp] of
    the bootstrapping key (the columns [index·T/tp, (index+1)·T/tp) of
    every step's matrix, T = rows·N) and the same share of the key-switch
    key's rows.  Where tp does not divide a contraction (or T/tp is not a
    multiple of 8) the last slice is padded with zero rows, which add
    nothing to a product.  A new contiguous tensor on ``fast``'s
    device."""
    if fast.orientation != "matmul" or fast.shard != (0, 1):
        raise ValueError(f"shard_contraction: a whole \"matmul\" key, not "
                         f"{fast.orientation!r} slice {fast.shard}")
    if not 0 <= index < tp:
        raise ValueError(f"slice {index} of {tp}")
    if tp == 1:
        return fast

    def cut(x: torch.Tensor, dim: int, width: int) -> torch.Tensor:
        part = x.narrow(dim, index * width,
                        max(0, min(width, x.shape[dim] - index * width)))
        pad = [0, 0] * (x.ndim - 1 - dim) + [0, width - part.shape[dim]]
        return torch.nn.functional.pad(part, pad).contiguous()

    rows = fast.ksk_matrix.shape[0]
    bsk = cut(fast.bsk_kernels, 2, _contraction_width(fast.params, tp))
    ksk = cut(fast.ksk_matrix, 0, -(-rows // (8 * tp)) * 8)
    return FastKeys(fast.params, bsk, ksk, "matmul", (index, tp))


def _init_acc(b_t: torch.Tensor, test_polys: torch.Tensor,
              params: TFHEParams) -> torch.Tensor:
    """ACC [B, k+1, N] int32: zero masks, the body the test polynomial
    rotated by (2N − b) mod 2N."""
    k, N = params.glwe_dim, params.poly_size
    acc = torch.zeros((b_t.shape[0], k + 1, N), dtype=I32,
                      device=b_t.device)
    acc[:, k] = monomial_rotate(test_polys, (2 * N - b_t) % (2 * N))
    return acc


def rotate(acc: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """X^amount · ACC as int64 (congruent mod 2^32): [B, k+1, N], amount
    [B] in [0, 2N).  A gather from [ACC, −ACC], whose index (t − a) mod 2N
    folds X^N = −1 into the table."""
    batch, k1, n = acc.shape
    ar = torch.arange(n, device=acc.device)
    idx = (ar - amount.to(I64)[:, None]) % (2 * n)           # [B, N]
    a64 = acc.to(I64)
    ext = torch.cat([a64, -a64], dim=-1)                      # [B, k1, 2N]
    return ext.gather(-1, idx[:, None, :].expand(batch, k1, n))


def step_digits(diff: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Gadget digits of ``diff`` [B, k+1, N] (any integer dtype, congruent
    mod 2^32) as the product's operand [B, rows·N] int8, row-major
    (component, level), then j: the balanced digits of
    :func:`..tfhe.numeric.gadget_decompose`, by the fused kernels' biased
    add (:func:`.fused_blind_rotate.decompose_digits`), which has no carry
    loop."""
    digits = decompose_digits(diff, params.bsk_base_log, params.bsk_level)
    return torch.stack(digits, dim=2).to(torch.int8) \
        .view(diff.shape[0], -1)


def _matmul_product(flat: torch.Tensor, kern: torch.Tensor,
                    params: TFHEParams) -> torch.Tensor:
    """The digits [B, T] times a ``"matmul"`` step's [D, T] matrix, the
    limbs shift-added: [B, (k+1)·N] int64.  One ``torch._int_mm`` of the
    digits and ``kern`` read as it lies in the key (never copied)."""
    prods = int8_matmul_nt(flat, kern).to(I64)                # [B, D]
    k1n = (params.glwe_dim + 1) * params.poly_size
    limbs = kern.shape[0] // k1n
    prods = prods.view(flat.shape[0], limbs, k1n)
    drop = N_LIMBS - limbs
    return sum(prods[:, m] * (1 << (LIMB_BITS * (m + drop)))
               for m in range(limbs))


def key_product(flat: torch.Tensor, fast: FastKeys,
                step: int) -> torch.Tensor:
    """The digits [B, rows·N] times step ``step``'s key, the limbs
    shift-added: [B, (k+1)·N] int64, congruent mod 2^32 to the product.
    ``"matmul"``: over ``fast``'s slice of the contraction
    (:func:`_matmul_product`); a conv orientation: :func:`conv_product`."""
    kern = fast.bsk_kernels[step]
    if fast.orientation in CONV_ORIENTATIONS:
        return conv_product(flat, kern, fast.params, fast.orientation)
    return _matmul_product(_slice_cols(flat, fast.shard, kern.shape[1]),
                           kern, fast.params)


# ------------------------------------------------------------- conv

def conv_step_matrix(kern: torch.Tensor, params: TFHEParams,
                     orientation: str) -> torch.Tensor:
    """A conv step's key ``kern`` (``bsk_kernels[i]``, [(k+1)·4, rows, W])
    as the B operand of its product: row-major [(k+1)·4·N, C] in ``kern``'s
    dtype, row (component, limb, t), column (row r, m).  A view of the key's
    windows, reshaped: the step's one copy of its key.

    * ``"keys_lhs"``, ``"keys_lhs_bf16"``: C = rows·N, entry E[t + 1 + m]
      of the extension E = [−K, K]; against the reversed digits this is
      JAX's conv with the digits as weights, its output shifted by one.
    * ``"keys_rhs"``: C = rows·2N, entry K̃[t + m] of the limbs of K
      zero-padded to [0]·(N−1), K, [0]·N; against the reversed extension
      [−d, d] of the digits, which carries the negacyclic sign (JAX's conv
      with the key as weights), since a negated int8 limb of −128 has no
      int8 form."""
    N = params.poly_size
    if orientation == "keys_rhs":
        padded = torch.nn.functional.pad(kern.flip(-1), (N - 1, N))
        win = padded.unfold(-1, 2 * N, 1)[:, :, :N]           # [G, r, N, 2N]
    else:
        win = kern.unfold(-1, N, 1)[:, :, 1:]                 # [G, r, N, N]
    return win.permute(0, 2, 1, 3).reshape(-1, win.shape[1] * win.shape[3])


def _bf16_product(d: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """int8 digits ``d`` [B, C] times the bf16 matrix ``mat`` [D, C]ᵀ,
    exactly, as int64 [B, D]: JAX's two sub-digit products, d = 16·d_hi +
    d_lo with |d_lo| ≤ 8 and |d_hi| ≤ 4, here one product of the 2B rows
    [d_lo; d_hi] with fp32 output on CUDA (every sum an integer below
    2^24, :func:`conv_unsupported`) and in float64 on the CPU."""
    d = d.to(torch.int16)
    lo = ((d + 8) & 15) - 8                                   # [-8, 7]
    both = torch.cat([lo, (d - lo) >> 4])                     # hi in [-4, 4]
    if d.is_cuda:
        out = torch.mm(both.to(torch.bfloat16), mat.t(),
                       out_dtype=torch.float32)
    else:
        out = both.to(torch.float64) @ mat.to(torch.float64).t()
    out = out.to(I64)
    batch = d.shape[0]
    return out[:batch] + out[batch:] * 16


def conv_product(flat: torch.Tensor, kern: torch.Tensor, params: TFHEParams,
                 orientation: str) -> torch.Tensor:
    """The digits ``flat`` [B, rows·N] int8 (:func:`step_digits`) times one
    step's conv key ``kern``, the limbs shift-added: [B, (k+1)·N] int64,
    congruent mod 2^32 to JAX's ``external_product_conv``.  One product of
    the reversed digits (``"keys_rhs"``: their extension) and
    :func:`conv_step_matrix`: ``torch._int_mm`` for the int8 layouts, the
    sub-digit bf16 product for ``"keys_lhs_bf16"``."""
    batch, N = flat.shape[0], params.poly_size
    k1 = params.glwe_dim + 1
    d = flat.view(batch, -1, N).flip(-1)                      # reversed
    if orientation == "keys_rhs":
        d = torch.cat([d, -d], dim=-1)                    # [−d, d] reversed
    d = d.reshape(batch, -1)
    mat = conv_step_matrix(kern, params, orientation)
    if orientation == "keys_lhs_bf16":
        prods = _bf16_product(d, mat)
    else:
        prods = int8_matmul_nt(d, mat).to(I64)
    prods = prods.view(batch, k1, N_LIMBS, N)                 # (comp, limb)
    return sum(prods[:, :, m] * (1 << (LIMB_BITS * m))
               for m in range(N_LIMBS)).view(batch, k1 * N)


def external_product_conv(diff: torch.Tensor, kernels: torch.Tensor,
                          params: TFHEParams,
                          orientation: str = "keys_rhs") -> torch.Tensor:
    """GGSW ⊡ diff for one step, [B, k+1, N] -> [B, k+1, N] int32: JAX's
    public ``external_product_conv``, every branch.  ``kernels``: one
    step's key in ``orientation``'s layout (``bsk_kernels[i]``; for
    ``"matmul"`` the port's K-major [D, T], the transpose of JAX's)."""
    flat = step_digits(diff.to(I64), params)
    if orientation == "matmul":
        prods = _matmul_product(flat, kernels, params)
    else:
        prods = conv_product(flat, kernels, params, orientation)
    return wrap32(prods).view(diff.shape)


def cmux_partial(acc: torch.Tensor, amount: torch.Tensor,
                 fast: FastKeys, step: int) -> torch.Tensor:
    """One CMux step's external product GGSW_step ⊡ (X^amount·ACC − ACC)
    over ``fast``'s slice of the contraction: [B, k+1, N] int64, congruent
    mod 2^32 (linear, so the slices' partials add up to the whole
    product).  JAX's matmul branch of ``external_product_conv`` and
    ``_combine_limbs``: :func:`rotate`, :func:`step_digits`,
    :func:`key_product`.  ``amount``: [B] rotation amounts in [0, 2N)."""
    a64 = acc.to(I64)
    diff = rotate(a64, amount) - a64
    return key_product(step_digits(diff, fast.params), fast, step) \
        .view(acc.shape)


def _all_reduce(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum mod 2^32 of ``parts`` (one integer tensor a position), on
    each position's device, congruent mod 2^32: the parts as int32 (what
    moves between devices), summed once a device with the other devices'
    parts copied in.  A copy between two cards is ordered after the work
    that made it and before the work that reads it by CUDA events on both
    devices' streams, so the host never waits.  One part is its own sum."""
    if len(parts) == 1:
        return parts
    parts = [wrap32(p) for p in parts]
    sums: dict[torch.device, torch.Tensor] = {}
    for p in parts:
        if p.device not in sums:
            sums[p.device] = sum(q.to(p.device).to(I64) for q in parts)
    return [sums[p.device] for p in parts]


def bootstrap_matmul(shards: list[FastKeys], big_cts: list[torch.Tensor],
                     test_polys: list[torch.Tensor],
                     posts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Batched FBS through JAX's XLA scan: the ``"matmul"`` orientation,
    its contractions split over the positions of one tp group, or a conv
    orientation at one position (tp = 1): ``shards[j]`` is slice j of
    the keys (:func:`shard_contraction`; one whole key for tp = 1), and
    every position holds the same ciphertexts, test polynomials and
    offsets on its device.  The key switch's partial sums are reduced once
    a bootstrap, each CMux step's once a step ([B, k+1, N] int32, the limbs
    already combined), and every position adds the sum to its own copy of
    ACC, so each returns the same [B, kN+1] outputs.  JAX
    ``_fbs_fast_impl``'s matmul scan (``ops/blind_rotate.py:350-372``),
    with the port's gather rotation in place of the one-hot one, and its
    conv ``fori_loop`` (``:361-366``); on CUDA it issues every step without
    a host sync."""
    params = shards[0].params
    n = params.lwe_dim
    body = [add_body(c, params.half_window) for c in big_cts]
    ks = _all_reduce([keyswitch_partial(c, f) for c, f in zip(body, shards)])
    small = [_keyswitch_finish(p, c, params) for p, c in zip(ks, body)]
    amounts = [_modswitch(s, params) for s in small]          # [B, n+1]
    acc = [_init_acc(a[:, n], tv, params)
           for a, tv in zip(amounts, test_polys)]
    steps = [a[:, :n].t().contiguous() for a in amounts]      # [n, B]
    for i in range(n):
        parts = [cmux_partial(x, a[i], f, i)
                 for x, a, f in zip(acc, steps, shards)]
        acc = [wrap32(x.to(I64) + s)
               for x, s in zip(acc, _all_reduce(parts))]
    return [add_body(sample_extract(x, params), p)
            for x, p in zip(acc, posts)]


def functional_bootstrap_fast(fast: FastKeys, big_cts: torch.Tensor,
                              test_polys: torch.Tensor,
                              posts: torch.Tensor,
                              launch: profiling.Launch | None = None,
                              choice=None) -> torch.Tensor:
    """Batched FBS through ``fast.orientation``: one launch of its fused
    kernel, or the ``"matmul"`` or conv scan (:func:`bootstrap_matmul` on
    one position); semantics identical to
    :func:`..tfhe.pbs.functional_bootstrap`.  ``launch``: the call's entry
    of the launch record, made at the fused kernel's launch
    (:func:`.fused_blind_rotate.blind_rotate_fused`) or around a library
    orientation's whole scan.  ``choice``: the launch as the cost model
    chose it (``optimizer.runtime_model.launch_choice``), whose ``route``
    and ``tile`` (K1's route and small-tile (tile, cluster)) the kernel
    runs; without one K1 runs its ring kernel at N ≥ 256."""
    if fast.orientation not in ("fused", "fused_otf"):
        with profiling.launch(launch):
            return bootstrap_matmul([fast], [big_cts], [test_polys],
                                    [posts])[0]
    params = fast.params
    n, N = params.lwe_dim, params.poly_size
    small = keyswitch_fast(add_body(big_cts, params.half_window), fast)
    a_t = _modswitch(small[:, :n], params)
    b_t = _modswitch(small[:, n], params)
    b_init = ((2 * N - b_t) % (2 * N))[:, None].contiguous()
    a_steps = a_t.t()[:, :, None].contiguous()
    route, tile = (choice.route, choice.tile) if choice else (None, None)
    cb, cluster = tile or (None, None)
    acc = blind_rotate_fused(b_init, a_steps, test_polys.contiguous(),
                             fast.bsk_kernels, params, cb, launch, route,
                             cluster, fast.hankel)
    return add_body(sample_extract(acc.permute(1, 0, 2), params), posts)
