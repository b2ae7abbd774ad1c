"""Staged (two-stage) functional bootstrap for large FBS sizes.

The counterpart of ``tfhe_fbs_map_tpu.tfhe.staged``, bitwise equal to it:
the same split of a size-p node into a size-(p/2) stage 1 and a size-8
select stage, the same keys for the same seed, the same ciphertexts.

A size-p node with lincomb ``x = sum c_i w_i + k0`` is split as ``x = x_lo
+ m*x_hi`` with ``m = p/2``: the inputs whose coefficient is not a multiple
of m form ``x_lo`` (which must stay below m), the rest the branch index
``x_hi`` in [0, 4).  Stage 1 re-grids ``x_lo`` onto q/p and emits the
packed pair ``G = f(x_lo) + 2 f(x_lo + m)`` on the select grid; stage 2
looks up ``z = G + 4*x_hi`` in a length-16 negacyclic table at p = 8.  Both
stages run at N <= 1024 where one size-p bootstrap needs N = 2048.

The two families share one master GLWE secret, viewed as (k1, N1) and (k2,
N2) polynomials with k1*N1 == k2*N2, and one small LWE key, so the wires
either family produces live under the same extracted key.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .encrypt import encode, lwe_encrypt
from .keys import TFHEKeys, generate_keys
from .params import TFHEParams
from .pbs import build_test_vector

__all__ = ["StagedSplit", "split_node", "StagedKeys", "generate_staged_keys",
           "staged_tvs", "staged_functional_bootstrap", "encrypt_wires",
           "SELECT_P"]

# Stage 2 (branch select) always runs on the p=8 grid: z = G + 4*x_hi with
# G in [0,4) and x_hi in [0,4) spans [0,16) = one negacyclic length-16 table.
SELECT_P = 8


@dataclass(frozen=True)
class StagedSplit:
    """Compile-time description of one staged size-p node."""

    p: int                     # original FBS size
    m: int                     # digit modulus = p // 2 (stage-1 FBS size)
    a_idx: tuple[int, ...]     # term indices feeding stage-1 (x_lo)
    b_idx: tuple[int, ...]     # term indices feeding stage-2 (x_hi)
    const_lo: int              # stage-1 constant, x_lo units
    const_hi: int              # stage-2 constant, branch units
    h_max: int                 # max branch index reached
    t1: tuple[int, ...]        # stage-1 packed table, values in [0, 4)
    t2: tuple[int, ...]        # stage-2 select table (negacyclic at p=8)


def split_node(coefs, const: int, table, p: int,
               bounds=None) -> StagedSplit | None:
    """Try to split a size-p bootstrap node; None -> run it natively.

    Requirements: p even and >= 8, a binary table, and the part of the
    lincomb whose coefficients are not multiples of m must fit one digit
    [0, m) over the wire box (``bounds``: per-term wire value upper bounds,
    default binary wires).  The digit constant ``s ≡ const (mod m)`` is the
    smallest that keeps ``x_lo`` non-negative; the rest of ``const`` goes to
    the branch index.  Tables stay binary because packing a V-valued pair
    needs a select grid of 2·V², and V = 4 would need an N >= 2048 select
    family."""
    coefs = [int(c) for c in coefs]
    table = [int(t) for t in table]
    const = int(const)
    if p % 2 or p < 8:
        return None
    m = p // 2
    tau = len(table)
    if tau > 2 * p or not table:
        return None
    if any(t not in (0, 1) for t in table):
        return None
    if bounds is None:
        bounds = [1] * len(coefs)
    bounds = [int(b) for b in bounds]
    a_idx = tuple(i for i, c in enumerate(coefs) if c % m)
    b_idx = tuple(i for i, c in enumerate(coefs) if not c % m)
    lo_min = sum(min(0, coefs[i] * bounds[i]) for i in a_idx)
    lo_span = sum(max(0, coefs[i] * bounds[i]) for i in a_idx) - lo_min
    s = const % m
    if lo_min + s < 0:
        s += m * ((-(lo_min + s) + m - 1) // m)
    if lo_span + lo_min + s >= m:
        return None                       # x_lo would overflow the digit
    const_lo, const_hi = s, (const - s) // m
    lo_max = lo_span + lo_min + s
    h_min = sum(min(0, (coefs[i] // m) * bounds[i]) for i in b_idx) \
        + const_hi
    if h_min < 0:
        return None                       # branch index would go negative
    h_max = sum(max(0, (coefs[i] // m) * bounds[i]) for i in b_idx) \
        + const_hi
    if h_max < 1:
        return None                       # single branch: native (smaller p)
    if h_max > 3:
        return None                       # x beyond 2p: invalid node anyway
    c_neg = None
    if tau > p:
        c_neg = table[0] + table[p]
        if any(table[x] + table[x + p] != c_neg for x in range(tau - p)):
            return None                   # not negacyclic
    if h_max >= 2 and c_neg is None:
        return None                       # branches 2-3 unreachable via C

    def f_ext(j: int) -> int:
        if j < tau:
            return table[j]
        if c_neg is not None and 0 <= j - p < tau:
            return c_neg - table[j - p]
        return table[tau - 1]             # unreachable: any in-range value

    t1 = tuple(f_ext(v) + 2 * f_ext(v + m) for v in range(lo_max + 1))
    t2 = []
    for z in range(4 * (h_max + 1)):
        g, h = z & 3, z >> 2
        base = g & 1 if h % 2 == 0 else (g >> 1) & 1
        t2.append(base if h < 2 else c_neg - base)
    return StagedSplit(p=p, m=m, a_idx=a_idx, b_idx=b_idx,
                       const_lo=const_lo, const_hi=const_hi, h_max=h_max,
                       t1=t1, t2=tuple(t2))


@dataclass
class StagedKeys:
    """Two TFHE families sharing the extracted big key and the small LWE
    key.  ``keys1.params.p`` is p//2 (or p, where fam1 is the catch-all
    family); ``keys2.params.p`` is :data:`SELECT_P` (or p//2 where 8 does
    not divide p).  ``p`` is the wire-level FBS size: wires are encoded at
    ``delta_w = q / (2p)``."""

    p: int
    keys1: TFHEKeys
    keys2: TFHEKeys

    @property
    def wire_params(self) -> TFHEParams:
        """Params view for wire-level encode/decrypt (global grid)."""
        return self.keys1.params.with_p(self.p)

    @property
    def extracted_key(self) -> torch.Tensor:
        return self.keys1.extracted_key

    @property
    def device(self) -> torch.device:
        return self.keys1.device

    def to(self, device) -> "StagedKeys":
        """Both families' key material on ``device`` (copies, never new
        keys)."""
        if torch.device(device) == self.device:
            return self
        return StagedKeys(p=self.p, keys1=self.keys1.to(device),
                          keys2=self.keys2.to(device))


def generate_staged_keys(p: int, params1: TFHEParams, params2: TFHEParams,
                         seed: int = 0, *, device) -> StagedKeys:
    """Both families on ``device`` from one ``default_rng(seed)``: the master
    GLWE secret and the small key first, then fam1's keys, then fam2's."""
    if params1.big_dim != params2.big_dim:
        raise ValueError("families must share the extracted key dimension "
                         f"(k·N {params1.big_dim} != {params2.big_dim})")
    if params1.lwe_dim != params2.lwe_dim:
        raise ValueError("families must share the small LWE key "
                         f"(n {params1.lwe_dim} != {params2.lwe_dim})")
    # fam1 on the p/2 grid enables splits, on the p grid it takes every
    # table as one boot; fam2's grid must divide the wire grid
    if params1.p not in (p // 2, p) or not (
            params2.p == SELECT_P or p % params2.p == 0):
        raise ValueError(f"family grids p1={params1.p}, p2={params2.p} do "
                         f"not fit wire p={p}")
    rng = np.random.default_rng(seed)
    master = rng.integers(0, 2, params1.big_dim, dtype=np.int64) \
        .astype(np.int32)
    lwe = rng.integers(0, 2, params1.lwe_dim, dtype=np.int64) \
        .astype(np.int32)
    keys1 = generate_keys(params1, device=device, rng=rng, lwe_key=lwe,
                          glwe_key=master.reshape(params1.glwe_dim, -1))
    keys2 = generate_keys(params2, device=device, rng=rng, lwe_key=lwe,
                          glwe_key=master.reshape(params2.glwe_dim, -1))
    return StagedKeys(p=p, keys1=keys1, keys2=keys2)


def staged_tvs(split: StagedSplit, skeys: StagedKeys,
               out_delta: int | None = None):
    """((tv1, post1), (tv2, post2)) for the two stages: stage 1 emits G on
    the select grid, stage 2 the final bit at ``out_delta`` (default the
    wire delta)."""
    delta2 = skeys.keys2.params.delta
    if out_delta is None:
        out_delta = skeys.wire_params.delta
    tv1 = build_test_vector(split.t1, skeys.keys1.params, out_delta=delta2)
    tv2 = build_test_vector(split.t2, skeys.keys2.params, out_delta=out_delta)
    return tv1, tv2


def staged_functional_bootstrap(skeys: StagedKeys, split: StagedSplit,
                                cts: torch.Tensor, coefs,
                                out_delta: int | None = None,
                                fast1=None, fast2=None) -> torch.Tensor:
    """Evaluate one staged node on a batch, as a one-node level of the
    staged executor's step.

    ``cts`` [T, B, kN+1]: the node's input wires at the wire delta q/(2p);
    ``coefs`` the original lincomb coefficients.  Returns [B, kN+1]
    encrypting ``table[x]`` at ``out_delta``.  ``fast1`` / ``fast2``:
    optional :class:`..ops.blind_rotate.FastKeys` of the two families; a
    family given one runs its fused kernel."""
    from ..runtime.executor import _staged_level_step

    coefs = [int(c) for c in coefs]
    t, batch, d = cts.shape
    (tv1, post1), (tv2, post2) = staged_tvs(split, skeys, out_delta)
    width = max(len(split.a_idx), len(split.b_idx), 1)

    def i32(x) -> torch.Tensor:
        arr = np.asarray(x, dtype=np.int64).astype(np.uint32)
        return torch.from_numpy(arr.astype(np.int32)).to(cts.device)

    def terms(idx, mult: int):
        """The node's wire rows and multipliers, zero-padded to ``width``."""
        pad = [0] * (width - len(idx))
        return (i32([list(idx) + pad]),
                i32([[mult * coefs[i] for i in idx] + pad]))

    # rows 0..T-1 hold the inputs, row T the output, row T+1 the dummy that
    # takes stage 1's scatter; stage 1 re-grids x_lo to q/p (multiplier
    # 2c_i on q/(2p) wires), stage 2 adds G to the branch lincomb
    buf = torch.cat([cts, cts.new_zeros((2, batch, d))])
    _staged_level_step(
        skeys.keys1, skeys.keys2, fast1, fast2, 1, buf,
        *terms(split.a_idx, 2), i32([split.const_lo
                                     * skeys.keys1.params.delta]),
        i32(tv1[None]), i32([post1]), i32([t + 1]),
        *terms(split.b_idx, 1), i32([4 * split.const_hi
                                     * skeys.keys2.params.delta]),
        i32(tv2[None]), i32([post2]), i32([t]))
    return buf[t]


def encrypt_wires(skeys: StagedKeys, values, rng: np.random.Generator,
                  scale: int = 1) -> torch.Tensor:
    """Encrypt wire values at ``scale * delta_w`` under the shared big key."""
    params = skeys.wire_params
    mus = encode(np.asarray(values) * scale, params)
    return lwe_encrypt(skeys.extracted_key, mus, params.glwe_noise_std, rng)
