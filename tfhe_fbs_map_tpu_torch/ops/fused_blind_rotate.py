"""Fused blind rotation: the whole n-step recurrence in one kernel launch.

Hopper counterparts of the two Pallas kernel bodies in
``tfhe_fbs_map_tpu/ops/fused_blind_rotate.py`` (``pl.pallas_call`` at
``:351``, reached through ``_blind_rotate_call`` and
``blind_rotate_fused``):

* **K2** (orientation ``"fused"``, ``csrc/fused_blind_rotate_k2.cu``)
  replaces ``_kernel`` (``:102-142``).  Each step multiplies the int8 gadget
  digits [B, K] (K = rows·N) by a precomputed negacyclic key matrix, stored
  K-major as [L·(k+1)·N, K] int8 (the transpose of the JAX layout), and
  shift-adds the L limbs.  A step's key is 18.9 MB at the ``aes128_p4``
  preset (10.9 GB a launch), so what bounds K2 is how many ciphertexts
  share each key byte that reaches an SM.  A tile of ``cb`` (16-128)
  ciphertexts runs on a thread-block cluster of ``cluster`` CTAs; each CTA
  owns 1/cluster of the (k+1)·N output coefficients with all their limbs,
  reads only those key columns, and contracts on int8 tensor cores
  (``wgmma`` m64n(32L)k32) from a ring of shared-memory stages that TMA
  fills.  The accumulator lives in the output tensor and the digits in an
  L2-resident scratch, ordered between CTAs by cluster barriers.  On the
  H100 the ring's loads bound it, so :func:`k2_plan` picks the tile and
  the cluster that stream the fewest bytes a CTA in one wave of clusters.
* **K1** (orientation ``"fused_otf"``, ``csrc/fused_blind_rotate.cu``)
  replaces ``_kernel_otf`` (``:160-242``).  The key is the compact
  anti-periodic limb extension ``E = [limbs(−poly), limbs(poly)]`` ∈
  int8[2N] per (step, chunk, row), 73.7 KB a step at ``aes128_p4``, and the
  negacyclic matrix is ``M[j, t] = E[N+t−j]``.  K1 runs K2's schedule
  (cluster tiles of 64 or 128 ciphertexts, ACC in the output tensor,
  digits in an L2 scratch, ``wgmma``) but streams only the digits: the
  digit pass writes each row's digits reversed (j' = N−1−j), which makes
  the key operand a Hankel matrix ``B'[t, j'] = E[t+j'+1]``, and every
  8×16-byte core matrix of it is a 128-byte block ``H[w][i][c] =
  E[8w+i+1+c]``.  H depends on the key alone: :func:`hankel_table` builds
  its blocks at every 8-byte offset once a key (16× the key's bytes;
  ``FastKeys.hankel`` keeps it), and a producer thread bulk-copies each
  ring stage's run of blocks from it into shared memory while two
  consumer warpgroups point no-swizzle ``wgmma`` descriptors into them.
  The consumers never read ACC: they stage each column chunk's limb-summed
  sums in shared memory, and another thread adds them into ACC with a TMA
  reduce-add (``K1_EPILOGUES``).  A cluster carries one tile, or two in
  turns (``k1_kernel_pair``): while the consumers multiply one tile's step,
  a warp of their own reduce-adds the other's last one and digit warps
  write its next digits, so its epilogue, digit pass and cluster barriers
  run under the products.  :func:`k1_plan` picks the tile, the cluster, the
  coefficients a warpgroup (``nw``, the ``wgmma`` width) and the tiles a
  cluster by the shared-memory operand bytes a CTA reads; the kernel sizes
  its ring itself (:func:`k1_layout`).
* **K1 below N=256** (``csrc/fused_blind_rotate_k1_small.cu``) replaces
  ``_kernel_otf`` at N ∈ {32, 64, 128}, whose rows K1's 256-byte
  contraction slices do not divide (the Pallas kernel takes any N, its
  strip tile T = min(128, N)).  A thread-block cluster of ``cluster`` CTAs
  owns a tile of 16 ciphertexts for all n steps; CTA r computes the
  columns [r·span, (r+1)·span) of the (k+1)·N with all their limbs, its
  warps ``mma.sync`` m16n8k32 on groups of its n8 output tiles over slices
  of the contraction, the Hankel B fragments read as funnel-shifted windows
  of E, the slices' sums met in shared memory.  Every CTA keeps the whole
  tile's ACC in shared memory, double-buffered, computes all the digits
  itself and stores its span of the new ACC into every CTA's copy
  (distributed shared memory), one cluster barrier a step; the next pass's
  E rows arrive by ``cp.async.bulk`` while this one computes.  A step
  writes the digits of all k+1 components in one pass, or, where those and
  the key stages do not fit shared memory (large l), one pass a component
  (:func:`k1_small_plan`).  Below N=256 :func:`k1_plan` gives its plan, so
  the card and the runtime model see one K1 plan, and
  :func:`blind_rotate_k1` launches it and counts the launch as K1's.
* **K1's small-tile plan at N ≥ 256** (the same source,
  ``k1s_kernel_wide``): for launches of a few tiles, where the ring
  kernel's tiles of 64 leave most SMs idle.  Tiles of 16 or 32 on clusters
  of up to 16 CTAs; a CTA keeps only its span of the ACC, computes its
  span's digits (the rotated source words read from their owners over
  distributed shared memory) and stores them into every CTA, two cluster
  barriers a step (:func:`k1_wide_plan`).  The cost model takes it where
  the calibration prices its kernel below the ring kernel's at the launch
  size (``optimizer.runtime_model.launch_choice``) and hands the route, the
  tile and the cluster down to :func:`blind_rotate_k1`; the launch record
  then names it ``k1s``.  The kernel layer prices nothing: without a route
  a launch at N ≥ 256 runs the ring kernel.

The monomial rotation X^a·x, which the TPU does with a barrel shifter
because Mosaic has no lane rotate, is an index read in both.

Beside each kernel is its plain PyTorch version.  The wrappers take the
plain version only for tensors on the CPU; for CUDA tensors they launch the
kernel or raise.  ``LAUNCHES`` counts kernel launches per wrapper,
``K1_KERNELS`` K1's by the kernel that ran them, ``K1_EPILOGUES`` the ring
kernel's by their ACC epilogue, and ``HANKEL`` the ring kernel's tables
built and their bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ..tfhe.numeric import I32, I64, int8_matmul, round_shift_right, wrap32
from ..tfhe.params import TFHEParams
from ..utils import profiling

__all__ = ["blind_rotate_fused", "blind_rotate_k1", "blind_rotate_k2",
           "blind_rotate_k1_plain", "blind_rotate_k2_plain", "k1_plan",
           "k1_ring_plan", "k1_wide_plan", "K1_ROUTES",
           "k2_plan", "k1_small_plan", "k1_device_plan", "device_plan",
           "k1_layout", "k1_small_layout", "k1_small_smem", "k1s_clusters",
           "k1_resident", "hankel_table", "k1_operand",
           "K1Plan", "K1SmallPlan", "K2Plan", "LAUNCHES", "K1_KERNELS",
           "K1_EPILOGUES", "HANKEL"]

N_LIMBS = 4
LAUNCHES = {"k1": 0, "k2": 0}
# K1's launches (each also one of LAUNCHES["k1"]) by the kernel that ran
# them, as the device trace names it: the ring kernel (either schedule,
# ``k1_kernel`` and ``k1_kernel_pair``), the small-N kernel below
# N=K1_SLICE, its small-tile plan at N >= K1_SLICE
K1_KERNELS = {"k1_kernel": 0, "k1s_kernel": 0, "k1s_kernel_wide": 0}
# the ring kernel's launches (either schedule) by their ACC epilogue:
# ``reduce``, the product warps stage each column chunk's limb-summed sums
# in shared memory and a TMA reduce-add adds them into ACC; ``load_store``,
# the product warps load, add and store ACC themselves (no ring kernel of
# this source)
K1_EPILOGUES = {"reduce": 0, "load_store": 0}
# the ring kernel's tables of H blocks built (:func:`hankel_table`, once a
# key whose launches take the ring) and the bytes they hold
HANKEL = {"tables": 0, "bytes": 0}

# Shared memory a block may opt into on sm_90 (227 KB).
SMEM_MAX = 232448
# K1: ciphertexts per cluster tile and coefficients per warpgroup (the
# wgmma's N) it is instantiated for, largest first; contraction bytes per
# ring stage; accumulator registers a thread may hold ((cb/64)·L·nw/2);
# CTAs a cluster; the largest N it serves: chip_smoke.py phase 11 (a) holds
# it bitwise against its plain version at N = 4096 (k=1, every plan k1_plan
# picks for 64, 512 and 2048 ciphertexts, 4 and 3 limbs, a ragged tile) and
# runs it at full length there (n=700, 512 ciphertexts).
K1_TILES = (128, 64)
K1_WIDTHS = (64, 32)
# tiles a cluster of the ring kernel carries: one (``k1_kernel``), or two
# in turns (``k1_kernel_pair``), whose cluster takes up to K1_PAIR_COST
# times a single tile's time at the same tile, span and width (timed back
# to back on an H100 80GB HBM3 with the reduce-add epilogue: 1.61-1.78 at
# AES-128's family, 1.77-1.90 at Kreyvium's fam1, whose deeper contraction
# leaves less to hide; the highest, so that a pair is taken where it gains
# at both)
K1_PAIRS = (1, 2)
K1_PAIR_COST = 1.9
K1_SLICE = 256
K1_ACC_REGS = 128
K1_MAX_CLUSTER = 16
K1_MAX_N = 4096
# K1 below K1_SLICE (csrc/fused_blind_rotate_k1_small.cu): ciphertexts a
# tile (mma.sync's M); warps a CTA; the n8 output tiles a warp holds that it
# is instantiated for (NT: a CTA's warps form groups of NT tiles, as many as
# cover its tiles rounded up to a power of two, each group's warps
# splitting the contraction: :func:`k1s_groups`); CTAs a cluster; the
# widest span of columns a CTA takes; the most columns (k+1)·N it serves
# (chip_smoke.py phase 12 (a) holds it bitwise at N ∈ {32, 64, 128}, k ∈
# {1, 2} and at the widest shapes).  Its shared memory, as the source lays
# it out (:func:`k1_small_smem`; the kernel's own count:
# :func:`k1_small_layout`): ACC 2 × [k+1][16][N + K1S_ACC_PAD] uint32, the
# digits [16][prow·N + K1S_DIG_PAD], two key stages of [L][comps][prow][2N]
# + K1S_E_PAD, each also the room of the slices' partial sums
# [slices][16][span + K1S_RED_PAD] uint32, the amounts [2][16] int32 and
# two mbarriers.
K1S_TILE = 16
K1S_WARPS = 8
K1S_TILES_A_WARP = (1, 2, 4)
K1S_MAX_CLUSTER = 8
K1S_MAX_SPAN = 128
K1S_MAX_KN = 512
K1S_ACC_PAD, K1S_DIG_PAD, K1S_E_PAD, K1S_RED_PAD = 8, 16, 16, 8
# Its small-tile plan at N ≥ K1_SLICE, for launches of few tiles
# (``k1s_kernel_wide``, :func:`k1_wide_plan`; the cost model sends a launch
# to it where the calibration prices it below the ring kernel): N up
# to K1S_WIDE_MAX_N at (k+1)·N up to K1S_WIDE_MAX_KN, tiles of
# K1S_WIDE_TILES ciphertexts (32: two row tiles of mma.sync share each key
# window), clusters up to K1S_WIDE_MAX_CLUSTER (non-portable above 8),
# spans up to K1S_WIDE_MAX_SPAN, at the limbs the optimizer picks
# (K1S_WIDE_LIMBS), one digit pass a step; a CTA keeps its span of the ACC
# [tile][span + K1S_ACC_PAD] uint32, all the digits [tile][rows·N +
# K1S_DIG_PAD] and two key stages of all the step's rows
# (:func:`k1_small_smem`).  chip_smoke.py phase 12 (d) holds it bitwise at
# every family it is calibrated at.  The routes of a K1 launch at N >=
# K1_SLICE, as the launch record names them: the ring kernel, the
# small-tile plan.
K1S_WIDE_MAX_N = 512
K1S_WIDE_MAX_KN = 1536
K1S_WIDE_MAX_CLUSTER = 16
K1S_WIDE_MAX_SPAN = 256
K1S_WIDE_LIMBS = (3, 4)
K1S_WIDE_TILES = (16, 32)
# its warps a CTA at each tile: 12 at 16 (three a scheduler), 8 at 32
K1S_WIDE_WARPS = {16: 12, 32: 8}
K1_ROUTES = ("k1", "k1s")
# K2: ciphertexts per cluster tile it is instantiated for, largest first;
# coefficients per column chunk (times L limbs: the GEMM columns one pass
# holds in registers); contraction bytes per ring stage; digit rows a stage
# holds at least (wgmma's M); shared memory beside the ring (1024-byte
# alignment of the swizzled tiles, the stages' mbarriers); ring stages (3
# measured fastest on the H100, 2 and 4 slower); CTAs a cluster (above 8 a
# non-portable size, which the H100 allows up to 16).
K2_TILES = (128, 64, 32, 16)
K2_CHUNK = 64
K2_KC = 128
K2_ROWS = 64
K2_SMEM_EXTRA = 2048
K2_MAX_STAGES = 3
K2_MAX_CLUSTER = 16


# --------------------------------------------------------------- plain

def barrel_rotate(x: torch.Tensor, amt: torch.Tensor) -> torch.Tensor:
    """X^amt · x with per-row amounts, equal to the TPU ``_barrel_rotate``.

    ``x``: [R, N] int32; ``amt``: [R, 1] in [0, 2N).  The cyclic rotation by
    ``amt mod N``, negated where ``(t < amt mod N) XOR (amt >= N)``."""
    n = x.shape[-1]
    amt = amt.to(I64)
    a = amt & (n - 1)
    t = torch.arange(n, device=x.device)
    src = (t - a) & (n - 1)
    out = torch.gather(x.to(I64), 1, src.expand(x.shape))
    neg = (t < a) ^ ((amt & n) != 0)
    return wrap32(torch.where(neg, -out, out))


def decompose_digits(diff: torch.Tensor, base_log: int,
                     levels: int) -> list[torch.Tensor]:
    """Balanced signed gadget digits, most-significant level first, by the
    biased add of the TPU ``_decompose_digits``: adding ``half`` at every
    level position lets the digit carries ride one add's carry chain."""
    b, l = base_log, levels
    closest = round_shift_right(diff, 32 - b * l)
    half, mask = 1 << (b - 1), (1 << b) - 1
    w = (closest + sum(half << (b * i) for i in range(l))) & 0xFFFFFFFF
    return [(((w >> (b * i)) & mask) - half).to(I32) for i in range(l)][::-1]


def _init_acc(b_init, test_polys, params: TFHEParams) -> torch.Tensor:
    """ACC = (0, …, 0, X^{b_init}·tv): [k+1, B, N] int32."""
    k1 = params.glwe_dim + 1
    batch, n = test_polys.shape
    acc = torch.zeros((k1, batch, n), dtype=I32, device=test_polys.device)
    acc[k1 - 1] = barrel_rotate(test_polys, b_init)
    return acc


def _step_digits(acc: torch.Tensor, amt: torch.Tensor,
                 params: TFHEParams) -> torch.Tensor:
    """Digits of X^amt·ACC − ACC as int8 [B, rows·N], row (c·l + lev)."""
    k1, batch, n = acc.shape
    l = params.bsk_level
    flat = acc.reshape(k1 * batch, n)
    diff = wrap32(barrel_rotate(flat, amt.repeat(k1, 1)).to(I64)
                  - flat.to(I64))
    d = torch.stack(decompose_digits(diff, params.bsk_base_log, l))
    return d.reshape(l, k1, batch, n).permute(2, 1, 0, 3) \
        .reshape(batch, k1 * l * n).to(torch.int8)


def _accumulate(acc: torch.Tensor, prods: torch.Tensor,
                n_limbs: int) -> torch.Tensor:
    """ACC[comp] += Σ_limb prods[:, limb, comp] << 8·(limb + drop)."""
    k1, batch, n = acc.shape
    drop = N_LIMBS - n_limbs
    p = prods.reshape(batch, n_limbs, k1, n).to(I64)
    scale = torch.tensor([1 << (8 * (m + drop)) for m in range(n_limbs)],
                         dtype=I64, device=acc.device)
    add = (p * scale[None, :, None, None]).sum(1)         # [B, k+1, N]
    return wrap32(acc.to(I64) + add.permute(1, 0, 2))


def otf_matrix(ext: torch.Tensor, n: int) -> torch.Tensor:
    """Compact extensions [L·(k+1), rows, 2N] -> the step's negacyclic key
    matrix [rows·N, L·(k+1)·N] (the JAX ``"fused"`` layout; K2's is its
    transpose): M[(r, j), (chunk, t)] = E[chunk, r, N + t − j]."""
    ar = torch.arange(n, device=ext.device)
    idx = n + ar[None, :] - ar[:, None]                   # [j, t]
    m = ext[:, :, idx]                                    # [C, rows, j, t]
    chunks, rows = ext.shape[:2]
    return m.permute(1, 2, 0, 3).reshape(rows * n, chunks * n)


def blind_rotate_k2_plain(b_init, a_t, test_polys, kernels,
                          params: TFHEParams) -> torch.Tensor:
    """Plain version of K2: keys [n, L·(k+1)·N, rows·N] int8, K-major (each
    step's matrix is the transpose of the JAX layout's)."""
    k1, n = params.glwe_dim + 1, params.poly_size
    n_limbs = kernels.shape[1] // (k1 * n)
    acc = _init_acc(b_init, test_polys, params)
    for i in range(a_t.shape[0]):
        dig = _step_digits(acc, a_t[i], params)
        acc = _accumulate(acc, int8_matmul(dig, kernels[i].t()), n_limbs)
    return acc


def blind_rotate_k1_plain(b_init, a_t, test_polys, kernels,
                          params: TFHEParams) -> torch.Tensor:
    """Plain version of K1: keys [n, L·(k+1), rows, 2N] int8."""
    k1, n = params.glwe_dim + 1, params.poly_size
    n_limbs = kernels.shape[1] // k1
    acc = _init_acc(b_init, test_polys, params)
    for i in range(a_t.shape[0]):
        dig = _step_digits(acc, a_t[i], params)
        mat = otf_matrix(kernels[i], n)
        acc = _accumulate(acc, int8_matmul(dig, mat), n_limbs)
    return acc


def hankel_table(kernels: torch.Tensor) -> torch.Tensor:
    """K1's compact keys [n, L·(k+1), rows, 2N] int8 -> the ring kernel's
    table of H blocks [n, L·(k+1), rows, 2N/8, 128] int8, on their device.

    Block w of a (step, limb, component, row) holds at row i the 16 bytes
    E[8w+i+1 .. 8w+i+17) of its extension E, zeros past 2N: the 8×16-byte
    core matrix at offset 8w of the Hankel key operand ``B'[t, j'] =
    E[t+j'+1]`` (the module's docstring).  A ring stage's blocks of one limb
    are the run from w = (t_c + j0')/8 (its chunk's first coefficient and
    its slice's first column), which the kernel copies whole; no run
    reaches the zeros.  One gather, 16× the key's bytes; counted under
    ``HANKEL``."""
    width = kernels.shape[-1]
    ext = torch.nn.functional.pad(kernels, (0, 16))
    table = ext.unfold(-1, 16, 1)[..., 1:width + 1, :] \
        .reshape(*kernels.shape[:-1], width // 8, 128)
    HANKEL["tables"] += 1
    HANKEL["bytes"] += table.numel()
    return table


# ------------------------------------------------------------- kernels

class K1Plan(NamedTuple):
    """How K1 launches: ``cb`` ciphertexts per tile, ``cluster`` CTAs per
    tile (CTA r owns coefficients [r·span, (r+1)·span) of the (k+1)·N, span
    = (k+1)·N / cluster), ``nw`` coefficients per warpgroup (a column chunk
    is 2·nw), ``pair`` tiles a cluster carries: 1, or 2 in turns
    (``k1_kernel_pair``: one tile's digit pass and cluster barriers under
    the other's products; an odd tile count runs its last tile alone).
    The kernel sizes its ring from (limbs, cb, nw): :func:`k1_layout`."""
    cb: int
    cluster: int
    nw: int
    pair: int = 1


class K1SmallPlan(NamedTuple):
    """How K1 launches below N=K1_SLICE: ``cb`` ciphertexts a tile,
    ``cluster`` CTAs a tile (CTA r owns columns [r·span, (r+1)·span) of the
    (k+1)·N, span = (k+1)·N / cluster), ``nt`` n8 output tiles a warp (the
    CTA's span/8 tiles in :func:`k1s_groups` groups; warp w holds group
    w % groups over contraction slice w // groups), ``passes`` digit passes
    a step (1: all k+1 components at once; k+1: one a component).  The
    kernel sizes its shared memory itself (:func:`k1_small_layout`)."""
    cb: int
    cluster: int
    nt: int
    passes: int


class K2Plan(NamedTuple):
    """How K2 launches: ``cb`` ciphertexts per tile, ``cluster`` CTAs per
    tile (CTA r owns coefficients [r·span, (r+1)·span) of the (k+1)·N, span
    = (k+1)·N / cluster), ``chunk`` coefficients per column chunk,
    ``stages`` shared-memory ring stages, ``smem`` bytes a CTA."""
    cb: int
    cluster: int
    chunk: int
    stages: int
    smem: int


def k1_clusters(params: TFHEParams, nw: int) -> list[int]:
    """Cluster sizes whose CTAs split the (k+1)·N coefficients into whole
    2·nw-coefficient chunks, largest first."""
    kn = (params.glwe_dim + 1) * params.poly_size
    return [c for c in range(K1_MAX_CLUSTER, 0, -1) if kn % (c * 2 * nw) == 0]


def k1_fits(cb: int, nw: int, n_limbs: int) -> bool:
    """Whether K1 is instantiated for (cb, nw) at ``n_limbs``: at most
    K1_ACC_REGS accumulator registers a thread."""
    return cb // 64 * n_limbs * nw // 2 <= K1_ACC_REGS


def k1_plan(batch: int, params: TFHEParams, sms: int,
            n_limbs: int = N_LIMBS, cb: int | None = None,
            cluster: int | None = None, nw: int | None = None,
            resident: Callable | None = None,
            route: str | None = None,
            pair: int | None = None) -> K1Plan | K1SmallPlan:
    """K1's launch plan for ``batch`` ciphertexts on ``sms`` SMs.

    Below N=K1_SLICE the small-N kernel's one plan (:func:`k1_small_plan`).
    Above, the plan of ``route`` (one of K1_ROUTES, as the cost model
    chose it): the small-tile plan (``"k1s"``, :func:`k1_wide_plan`) or the
    ring kernel's (``"k1"``, and without a route, :func:`k1_ring_plan`).
    ``cb``, ``cluster`` and ``nw`` are taken by the plan of the route.
    ``resident(plan)``: the clusters of a plan the card runs at once
    (default ``sms // cluster``)."""
    if params.poly_size < K1_SLICE:
        return k1_small_plan(params, n_limbs, cb, cluster, nw)
    route = route or "k1"
    if route not in K1_ROUTES:
        raise ValueError(f"route {route!r} not in {K1_ROUTES}")
    if route == "k1s":
        if nw is not None:
            raise ValueError(f"the small-tile plan takes no nw; got {nw}")
        return k1_wide_plan(batch, params, sms, n_limbs, cluster, resident,
                            cb)
    return k1_ring_plan(batch, params, sms, n_limbs, cb, cluster, nw,
                        resident, pair)


def k1_ring_plan(batch: int, params: TFHEParams, sms: int,
                 n_limbs: int = N_LIMBS, cb: int | None = None,
                 cluster: int | None = None, nw: int | None = None,
                 resident: Callable[[K1Plan], int] | None = None,
                 pair: int | None = None) -> K1Plan:
    """The ring kernel's plan (N ≥ K1_SLICE).

    Among the tiles ``cb``, widths ``nw``, cluster sizes and tiles a
    cluster (``pair``, K1_PAIRS) that K1 is instantiated for (or the ones
    given), the cheapest by the shared-memory bytes the ``wgmma`` operands
    take per CTA: a CTA multiplies cb digit rows by span·L key columns a
    step, and each m64n(nw)k32 reads 2 KB of digits and nw·32 bytes of H,
    so a cluster's cost is span × cb × (64 + nw) / nw, K1_PAIR_COST times
    that where it carries two tiles in turns, and a launch's its waves
    times that.  A wave is as many clusters as ``resident(plan)`` says the
    card runs at once (default ``sms // cluster``); a launch of ``pair``
    tiles a cluster takes ceil(tiles / pair) clusters, its last tile alone
    where their count is odd.  Ties go to fewer CTAs, then larger tiles
    and widths, then one tile a cluster."""
    if cb is not None and cb not in K1_TILES:
        raise ValueError(f"batch tile {cb} not in {K1_TILES}")
    if nw is not None and nw not in K1_WIDTHS:
        raise ValueError(f"width {nw} not in {K1_WIDTHS}")
    if pair is not None and pair not in K1_PAIRS:
        raise ValueError(f"tiles a cluster {pair} not in {K1_PAIRS}")
    if resident is None:
        def resident(p):
            return sms // p.cluster
    kn = (params.glwe_dim + 1) * params.poly_size
    best = None
    for t in [cb] if cb is not None else K1_TILES:
        for w in [nw] if nw is not None else K1_WIDTHS:
            if not k1_fits(t, w, n_limbs):
                continue
            for c in k1_clusters(params, w):
                if cluster is not None and c != cluster:
                    continue
                for pr in [pair] if pair is not None else K1_PAIRS:
                    plan = K1Plan(t, c, w, pr)
                    clusters = -(-(-(-max(batch, 1) // t)) // pr)
                    waves = -(-clusters // max(1, resident(plan)))
                    cost = waves * (kn // c) * t * (64 + w) / w
                    key = (cost * K1_PAIR_COST if pr == 2 else cost,
                           clusters * c, -t, -w, pr)
                    if best is None or key < best[0]:
                        best = (key, plan)
    if best is None:
        raise ValueError(f"K1 has no plan for cb={cb} cluster={cluster} "
                         f"nw={nw} pair={pair} at {n_limbs} limbs: a "
                         f"cluster must split "
                         f"the (k+1)·N coefficients into whole chunks")
    return best[1]


def _wide(params: TFHEParams) -> bool:
    return params.poly_size >= K1_SLICE


def k1s_clusters(params: TFHEParams, n_limbs: int = N_LIMBS,
                 cb: int = K1S_TILE) -> list[int]:
    """Cluster sizes the small-N K1 is built for at ``params`` and
    ``n_limbs``, largest first: at most K1S_MAX_CLUSTER CTAs (at N ≥
    K1_SLICE K1S_WIDE_MAX_CLUSTER, and none past K1S_WIDE_MAX_N,
    K1S_WIDE_MAX_KN or K1S_WIDE_LIMBS), each a span of whole n8 tiles, at
    most K1S_MAX_SPAN (K1S_WIDE_MAX_SPAN) columns, in a CTA's shared memory
    (:func:`k1_small_smem`, one digit pass a step or a component), at
    tiles of ``cb``."""
    k1 = params.glwe_dim + 1
    kn = k1 * params.poly_size
    wide = _wide(params)
    if wide:
        if (params.poly_size > K1S_WIDE_MAX_N or kn > K1S_WIDE_MAX_KN
                or n_limbs not in K1S_WIDE_LIMBS):
            return []
        most, widest = K1S_WIDE_MAX_CLUSTER, K1S_WIDE_MAX_SPAN
    else:
        most, widest = K1S_MAX_CLUSTER, K1S_MAX_SPAN
    # one digit pass a step at N >= K1_SLICE, else one a component at most
    passes = 1 if wide else k1
    warps = k1s_warps(params, cb)
    return [c for c in range(most, 0, -1)
            if kn % c == 0 and (kn // c) % 8 == 0 and kn // c <= widest
            and warps % k1s_groups(kn // c, k1s_tiles_a_warp(kn // c),
                                   wide) == 0
            and k1_small_smem(params, n_limbs, c, passes, cb) <= SMEM_MAX]


def k1s_tiles_a_warp(span: int) -> int:
    """n8 tiles a warp holds at a CTA span: all the span's (up to the most
    it is built for), so that the warps split the contraction."""
    tiles = span // 8
    return next(t for t in K1S_TILES_A_WARP
                if t >= tiles or t == K1S_TILES_A_WARP[-1])


def k1s_groups(span: int, nt: int, wide: bool = False) -> int:
    """Groups of ``nt`` n8 tiles a CTA's warps form at a span: as many as
    cover its tiles, rounded up to a power of two (``tile_groups`` in the
    source), so that they divide the warps; at N ≥ K1_SLICE (``wide``,
    ``wide_groups``) exactly as many, which must divide the warps."""
    if wide:
        return -(-(span // 8) // nt)
    groups = 1
    while groups * nt < span // 8:
        groups *= 2
    return groups


def k1s_warps(params: TFHEParams, cb: int = K1S_TILE) -> int:
    """Warps a CTA of the small-N K1 runs: K1S_WARPS, at N ≥ K1_SLICE
    K1S_WIDE_WARPS of the tile."""
    return K1S_WIDE_WARPS[cb] if _wide(params) else K1S_WARPS


def k1_small_smem(params: TFHEParams, n_limbs: int, cluster: int,
                  passes: int, cb: int = K1S_TILE) -> int:
    """Shared memory (bytes) a CTA of the small-N K1 takes, as its source
    lays it out (``layout``, at N ≥ K1_SLICE ``layout_wide``, in
    ``csrc/fused_blind_rotate_k1_small.cu``): the host's copy, which
    chooses the clusters and the digit passes without a card
    (``tests/test_torch_gpu.py`` holds it to the kernel's own count,
    :func:`k1_small_layout`), at tiles of ``cb``."""
    k1, n = params.glwe_dim + 1, params.poly_size
    prow = k1 * params.bsk_level // passes
    span = k1 * n // cluster
    comps = max((r * span + span - 1) // n - r * span // n + 1
                for r in range(cluster))
    slices = k1s_warps(params, cb) // k1s_groups(
        span, k1s_tiles_a_warp(span), _wide(params))
    stage = max(n_limbs * comps * prow * 2 * n + K1S_E_PAD,
                slices * cb * (span + K1S_RED_PAD) * 4)
    acc = (cb * (span + K1S_ACC_PAD) * 4 if _wide(params)
           else 2 * 4 * k1 * cb * (n + K1S_ACC_PAD))
    return (acc + cb * (prow * n + K1S_DIG_PAD) + 2 * stage + 2 * cb * 4
            + 2 * 8)


def _k1s_plan(params: TFHEParams, n_limbs: int, cluster: int,
              cb: int = K1S_TILE) -> K1SmallPlan:
    """The small-N kernel's plan on tiles of ``cb`` and clusters of
    ``cluster`` (one it is built for): one digit pass a step where its
    layout fits a CTA's shared memory (always at N ≥ K1_SLICE), else one a
    component."""
    k1 = params.glwe_dim + 1
    passes = (1 if k1_small_smem(params, n_limbs, cluster, 1, cb)
              <= SMEM_MAX else k1)   # a served cluster fits one a component
    span = k1 * params.poly_size // cluster
    return K1SmallPlan(cb, cluster, k1s_tiles_a_warp(span), passes)


@functools.lru_cache(maxsize=256)
def k1_small_plan(params: TFHEParams, n_limbs: int = N_LIMBS,
                  cb: int | None = None, cluster: int | None = None,
                  nw: int | None = None) -> K1SmallPlan:
    """The plan of K1's kernel for N < K1_SLICE at ``n_limbs``: tiles of
    K1S_TILE ciphertexts on clusters of ``cluster`` CTAs, by default the
    largest it is built for (:func:`k1s_clusters`), whose warps hold all
    the CTA's n8 tiles and split the contraction
    (:func:`k1s_tiles_a_warp`).  A step writes all its digits in one pass
    where they and the two key stages fit a CTA's shared memory, else one
    pass a component.  ``cb`` and ``nw`` are the ring kernel's knobs: only
    K1S_TILE and None are taken; a cluster the kernel is not built for is
    refused.  Cached: every launch asks for it."""
    if cb not in (None, K1S_TILE) or nw is not None:
        raise ValueError(f"K1 below N={K1_SLICE} takes tiles of {K1S_TILE} "
                         f"ciphertexts and no nw; got cb={cb} nw={nw}")
    k1 = params.glwe_dim + 1
    kn = k1 * params.poly_size
    served = k1s_clusters(params, n_limbs) if kn <= K1S_MAX_KN else []
    if not served:
        raise ValueError(f"(k+1)·N = {kn} > {K1S_MAX_KN}: the small-N K1 "
                         f"holds at most {K1S_TILES_A_WARP[-1]} n8 tiles a "
                         f"warp on clusters of at most {K1S_MAX_CLUSTER}")
    if cluster is not None and cluster not in served:
        raise ValueError(f"cluster {cluster}: K1 below N={K1_SLICE} is "
                         f"built for clusters {served} at (k+1)·N = {kn}")
    return _k1s_plan(params, n_limbs, cluster or served[0])


def k1_wide_plan(batch: int, params: TFHEParams, sms: int,
                 n_limbs: int = N_LIMBS, cluster: int | None = None,
                 resident: Callable[[K1SmallPlan], int] | None = None,
                 cb: int | None = None) -> K1SmallPlan:
    """The small-tile plan of K1 at N ≥ K1_SLICE for ``batch``
    ciphertexts, on tiles of ``cb`` and clusters of ``cluster`` where given
    (the cost model's, ``optimizer.runtime_model.launch_choice``).  Among
    the tiles of K1S_WIDE_TILES and the clusters each is built at
    (:func:`k1s_clusters`) that those leave, the one of the fewest waves,
    then the smaller tile, then the most CTAs a tile: a wave is as many
    clusters as ``resident(plan)`` says the card runs at once (default
    ``sms // cluster``)."""
    kn = (params.glwe_dim + 1) * params.poly_size
    tiles_ = [cb] if cb is not None else K1S_WIDE_TILES
    served = {t: k1s_clusters(params, n_limbs, t) for t in tiles_}
    if not any(served.values()):
        raise ValueError(
            f"the small-tile K1 serves N ≤ {K1S_WIDE_MAX_N} at (k+1)·N ≤ "
            f"{K1S_WIDE_MAX_KN}, tiles of {K1S_WIDE_TILES} and "
            f"{K1S_WIDE_LIMBS} limbs; got N = {params.poly_size}, (k+1)·N = "
            f"{kn}, {n_limbs} limbs, tile {cb}")
    if cluster is not None and not any(cluster in cs
                                       for cs in served.values()):
        raise ValueError(f"cluster {cluster}: the small-tile K1 is built for "
                         f"clusters {served} at (k+1)·N = {kn}")
    if resident is None:
        def resident(p):
            return sms // p.cluster
    best = None
    for t, cs in served.items():
        tiles = -(-max(batch, 1) // t)
        for c in [cluster] if cluster is not None else cs:
            if c not in cs:
                continue
            plan = _k1s_plan(params, n_limbs, c, t)
            key = (-(-tiles // max(1, resident(plan))), t, -c)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def k2_clusters(params: TFHEParams) -> list[int]:
    """Cluster sizes whose CTAs split the (k+1)·N coefficients into whole
    column chunks, largest first."""
    kn = (params.glwe_dim + 1) * params.poly_size
    return [c for c in range(K2_MAX_CLUSTER, 0, -1)
            if kn % (c * K2_CHUNK) == 0]


def k2_plan(batch: int, params: TFHEParams, sms: int,
            n_limbs: int = N_LIMBS, cb: int | None = None,
            cluster: int | None = None,
            resident: Callable[[K2Plan], int] | None = None) -> K2Plan:
    """K2's launch plan for ``batch`` ciphertexts on ``sms`` SMs.

    Among the tiles ``cb`` and cluster sizes that fit (or the ones given),
    the cheapest by the bytes a CTA streams: every ring stage carries
    max(cb, 64) digit rows and L·64 key rows, and a CTA runs (k+1)·N /
    cluster of the coefficients, so the cost is waves × (max(cb, 64) + L·64)
    / cluster.  A wave is as many clusters as ``resident(plan)`` says the
    card runs at once (default ``sms // cluster``: one CTA an SM).  Ties go
    to fewer CTAs, then larger tiles.  The ring takes as many stages as fit
    shared memory, at most K2_MAX_STAGES."""
    if resident is None:
        def resident(p):
            return sms // p.cluster
    best = None
    for t in [cb] if cb is not None else K2_TILES:
        rows = max(t, K2_ROWS) + n_limbs * K2_CHUNK
        stages = min(K2_MAX_STAGES,
                     (SMEM_MAX - K2_SMEM_EXTRA) // (rows * K2_KC))
        for c in [cluster] if cluster is not None else k2_clusters(params):
            plan = K2Plan(t, c, K2_CHUNK, stages,
                          stages * rows * K2_KC + K2_SMEM_EXTRA)
            tiles = -(-max(batch, 1) // t)
            waves = -(-tiles // max(1, resident(plan)))
            key = (waves * rows / c, tiles * c, -t)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def _card_plan(dev: torch.device, plan_fn, max_clusters, tag: tuple):
    """``plan_fn(sms, resident)`` with the SM count of ``dev`` and the
    clusters the card runs at once, as ``max_clusters(plan)``
    (``cudaOccupancyMaxActiveClusters``) reports them; cached under
    ``tag``."""
    with torch.cuda.device(dev):
        index = torch.cuda.current_device()
        sms = torch.cuda.get_device_properties(index).multi_processor_count

        def resident(p):
            key = (index, *tag, p)
            if key not in _RESIDENT:
                _RESIDENT[key] = max_clusters(p)
            return _RESIDENT[key]

        return plan_fn(sms, resident)


def device_plan(batch: int, params: TFHEParams, dev: torch.device,
                n_limbs: int = N_LIMBS, cb: int | None = None,
                cluster: int | None = None) -> K2Plan:
    """The plan K2 launches with on ``dev``: :func:`k2_plan` with the
    card's SM count and the clusters it runs at once."""
    return _card_plan(dev, lambda sms, res: k2_plan(
        batch, params, sms, n_limbs, cb, cluster, res),
        lambda p: k2_max_clusters(p, n_limbs), ("k2", n_limbs))


def k1_device_plan(batch: int, params: TFHEParams, dev: torch.device,
                   n_limbs: int = N_LIMBS, cb: int | None = None,
                   cluster: int | None = None, nw: int | None = None,
                   lib: ctypes.CDLL | None = None,
                   route: str | None = None,
                   pair: int | None = None) -> K1Plan | K1SmallPlan:
    """The plan K1 launches with on ``dev``: :func:`k1_plan` with the
    card's SM count and the clusters it runs at once (as ``lib``, default
    the built library, reports them)."""
    return _card_plan(dev, lambda sms, res: k1_plan(
        batch, params, sms, n_limbs, cb, cluster, nw, res, route, pair),
        lambda p: k1_resident(p, params, n_limbs, lib),
        ("k1", n_limbs, getattr(lib, "_name", None), params.glwe_dim,
         params.poly_size, params.bsk_level))


_RESIDENT: dict = {}


def unsupported(params: TFHEParams, otf: bool) -> str | None:
    """Why the CUDA kernel (K1 if ``otf`` else K2) cannot serve ``params``,
    or None when it can."""
    b, l, n = params.bsk_base_log, params.bsk_level, params.poly_size
    rows_n = (params.glwe_dim + 1) * l * n
    if b > 8:
        return f"bsk_base_log {b} > 8 does not fit int8 digits"
    if b * l >= 32:
        return f"bsk_base_log * bsk_level = {b * l} >= 32"
    if n % 32:
        return f"poly_size {n} is not a multiple of 32"
    if n & (n - 1):
        return f"poly_size {n} is not a power of two"
    if otf:
        # the small-tile plan at N >= K1_SLICE is an option of the ring
        # kernel's families (k1s_clusters), not a limit of them
        if n < K1_SLICE and (params.glwe_dim + 1) * n > K1S_MAX_KN:
            return (f"(k+1)·N = {(params.glwe_dim + 1) * n} > {K1S_MAX_KN}, "
                    f"the most K1 below N={K1_SLICE} serves")
        if rows_n << (b + 6) >= 1 << 31:
            return (f"rows·N·2^(b-1)·128 = {rows_n << (b + 6)} could "
                    f"overflow the int32 sums")
        if n > K1_MAX_N:
            return (f"poly_size {n} > {K1_MAX_N}, the largest K1 is "
                    f"checked at on the card")
        return None
    if rows_n % K2_KC:
        return f"rows·N = {rows_n} is not a multiple of {K2_KC}"
    if not k2_clusters(params):
        return (f"(k+1)·N = {(params.glwe_dim + 1) * n} is not a multiple "
                f"of {K2_CHUNK}")
    return None


def _check(otf: bool, b_init, a_t, test_polys, kernels,
           params: TFHEParams) -> int:
    """Validate a launch's operands; returns the number of limbs."""
    dev = test_polys.device
    k1, n, l = params.glwe_dim + 1, params.poly_size, params.bsk_level
    rows = k1 * l
    batch = test_polys.shape[0]
    steps = a_t.shape[0]
    for name, x, dt in (("b_init", b_init, I32), ("a_t", a_t, I32),
                        ("test_polys", test_polys, I32),
                        ("kernels", kernels, torch.int8)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    if otf:
        n_limbs = kernels.shape[1] // k1
        want = (steps, n_limbs * k1, rows, 2 * n)
    else:
        n_limbs = kernels.shape[1] // (k1 * n)
        want = (steps, n_limbs * k1 * n, rows * n)
    if (tuple(b_init.shape) != (batch, 1)
            or tuple(a_t.shape) != (steps, batch, 1)
            or tuple(test_polys.shape) != (batch, n)
            or tuple(kernels.shape) != want or not 1 <= n_limbs <= N_LIMBS):
        raise ValueError(
            f"shapes b_init {tuple(b_init.shape)} a_t {tuple(a_t.shape)} "
            f"test_polys {tuple(test_polys.shape)} kernels "
            f"{tuple(kernels.shape)} do not fit {params}")
    why = unsupported(params, otf)
    if why is None and kernels.data_ptr() % 16:
        why = "keys are not 16-byte aligned"
    if why is not None:
        raise ValueError(f"the fused CUDA kernel cannot serve {params}: {why}")
    return n_limbs


def _raise_on(err: int, lib: ctypes.CDLL | None = None) -> None:
    if err != 0:
        from . import _build
        text = getattr(lib, "fbr_error_string", None) \
            or _build.library().fbr_error_string
        msg = text(err)
        raise RuntimeError(f"fused blind rotation launch failed: "
                           f"{ctypes.string_at(msg).decode()} ({err})")


def k1_operand(plan: K1Plan | K1SmallPlan, kernels: torch.Tensor,
               hankel: Callable[[], torch.Tensor] | None = None
               ) -> torch.Tensor:
    """The key operand a K1 launch of ``plan`` reads: the compact keys for
    the small-N kernel's plans, the table of H blocks for the ring kernel's
    (``hankel()``, the keys' own, :meth:`..blind_rotate.FastKeys.hankel`;
    without it one built for this launch, :func:`hankel_table`).  A key
    whose launches never take the ring so never builds a table."""
    if isinstance(plan, K1SmallPlan):
        return kernels
    table = hankel() if hankel is not None else hankel_table(kernels)
    want = (*kernels.shape[:-1], kernels.shape[-1] // 8, 128)
    if (tuple(table.shape) != want or table.dtype != torch.int8
            or table.device != kernels.device or not table.is_contiguous()
            or table.data_ptr() % 16):
        raise ValueError(f"the ring kernel's table: want a contiguous, "
                         f"16-byte aligned int8 {want} on {kernels.device}, "
                         f"got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    return table


def _launch_k1(b_init, a_t, test_polys, kernels, params: TFHEParams,
               cb: int | None, cluster: int | None, nw: int | None,
               lib: ctypes.CDLL | None = None,
               route: str | None = None,
               hankel: Callable[[], torch.Tensor] | None = None,
               pair: int | None = None) -> torch.Tensor:
    """K1 on the card, through ``lib`` (default the built library), at the
    plan :func:`k1_device_plan` gives: the ring kernel's, reading the
    keys' table (:func:`k1_operand`), or the small-N kernel's (below
    N=K1_SLICE, and above it on the small-tile plan, where ``route`` is
    ``"k1s"``); counted under ``LAUNCHES`` and ``K1_KERNELS``, a ring
    launch also under ``K1_EPILOGUES``."""
    from . import _build

    n_limbs = _check(True, b_init, a_t, test_polys, kernels, params)
    dev = test_polys.device
    k1, n = params.glwe_dim + 1, params.poly_size
    batch, steps = test_polys.shape[0], a_t.shape[0]
    lib = lib or _build.library()
    plan = k1_device_plan(batch, params, dev, n_limbs, cb, cluster, nw,
                          lib, route, pair)
    if batch == 0 or steps == 0:
        return _init_acc(b_init, test_polys, params)
    keys = k1_operand(plan, kernels, hankel)
    out = torch.empty((k1, batch, n), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if isinstance(plan, K1SmallPlan):
            err = lib.fbr_k1s_blind_rotate(
                b_init.data_ptr(), a_t.data_ptr(), test_polys.data_ptr(),
                keys.data_ptr(), out.data_ptr(), steps, batch, n, k1,
                params.bsk_level, params.bsk_base_log, n_limbs, plan.cb,
                plan.cluster, plan.nt, plan.passes, stream)
        else:
            tiles = -(-batch // plan.cb)
            dig = torch.empty((tiles * plan.cb, k1 * params.bsk_level * n),
                              dtype=torch.int8, device=dev)
            err = lib.fbr_k1_blind_rotate(
                b_init.data_ptr(), a_t.data_ptr(), test_polys.data_ptr(),
                keys.data_ptr(), out.data_ptr(), dig.data_ptr(), steps,
                batch, n, k1, params.bsk_level, params.bsk_base_log, n_limbs,
                plan.cb, plan.nw, plan.cluster, plan.pair, stream)
    _raise_on(err, lib)
    LAUNCHES["k1"] += 1
    K1_KERNELS["k1_kernel" if isinstance(plan, K1Plan) else "k1s_kernel"
               if n < K1_SLICE else "k1s_kernel_wide"] += 1
    if isinstance(plan, K1Plan):
        K1_EPILOGUES["reduce"] += 1
    return out


def _launch_k2(b_init, a_t, test_polys, kernels, params: TFHEParams,
               cb: int | None, cluster: int | None) -> torch.Tensor:
    from . import _build

    n_limbs = _check(False, b_init, a_t, test_polys, kernels, params)
    dev = test_polys.device
    k1, n = params.glwe_dim + 1, params.poly_size
    batch, steps = test_polys.shape[0], a_t.shape[0]
    if cb is not None and cb not in K2_TILES:
        raise ValueError(f"batch tile {cb} not in {K2_TILES}")
    if cluster is not None and cluster not in k2_clusters(params):
        raise ValueError(f"cluster {cluster} not in {k2_clusters(params)}")
    if batch == 0 or steps == 0:
        return _init_acc(b_init, test_polys, params)
    out = torch.empty((k1, batch, n), dtype=I32, device=dev)
    plan = device_plan(batch, params, dev, n_limbs, cb, cluster)
    with torch.cuda.device(dev):
        tiles = -(-batch // plan.cb)
        dig = torch.empty((tiles * plan.cb, k1 * params.bsk_level * n),
                          dtype=torch.int8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _build.library().fbr_k2_blind_rotate(
            b_init.data_ptr(), a_t.data_ptr(), test_polys.data_ptr(),
            kernels.data_ptr(), out.data_ptr(), dig.data_ptr(), steps, batch,
            n, k1, params.bsk_level, params.bsk_base_log, n_limbs, plan.cb,
            plan.cluster, plan.stages, plan.smem, stream)
    _raise_on(err)
    LAUNCHES["k2"] += 1
    return out


def k2_max_clusters(plan: K2Plan, n_limbs: int = N_LIMBS) -> int:
    """Clusters of ``plan`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from . import _build

    count = ctypes.c_int(0)
    _raise_on(_build.library().fbr_k2_max_clusters(
        n_limbs, plan.cb, plan.cluster, plan.smem, ctypes.byref(count)))
    return count.value


def k1_max_clusters(plan: K1Plan, n_limbs: int = N_LIMBS,
                    lib: ctypes.CDLL | None = None) -> int:
    """Clusters of K1's ``plan`` the current card runs at once
    (``cudaOccupancyMaxActiveClusters``)."""
    from . import _build

    lib = lib or _build.library()
    count = ctypes.c_int(0)
    _raise_on(lib.fbr_k1_max_clusters(n_limbs, plan.cb, plan.nw,
                                      plan.cluster, plan.pair,
                                      ctypes.byref(count)), lib)
    return count.value


def k1_resident(plan: K1Plan | K1SmallPlan, params: TFHEParams,
                n_limbs: int = N_LIMBS,
                lib: ctypes.CDLL | None = None) -> int:
    """Clusters of either of K1's plans at ``params`` the current card runs
    at once."""
    if isinstance(plan, K1SmallPlan):
        return k1_small_layout(plan, params, n_limbs, lib)[1]
    return k1_max_clusters(plan, n_limbs, lib)


def k1_layout(plan: K1Plan, n_limbs: int = N_LIMBS,
              lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """The ring stages and the dynamic shared memory (bytes) a CTA of K1's
    ``plan`` launches with, as the kernel sizes them."""
    from . import _build

    lib = lib or _build.library()
    stages, smem = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.fbr_k1_layout(n_limbs, plan.cb, plan.nw,
                                ctypes.byref(stages), ctypes.byref(smem)),
              lib)
    return stages.value, smem.value


def k1_small_layout(plan: K1SmallPlan, params: TFHEParams,
                    n_limbs: int = N_LIMBS,
                    lib: ctypes.CDLL | None = None) -> tuple[int, int]:
    """The dynamic shared memory (bytes) a CTA of K1's small-N ``plan``
    launches with at ``params``, as the kernel sizes it, and the clusters
    of the plan the current card runs at once."""
    from . import _build

    lib = lib or _build.library()
    smem, clusters = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(lib.fbr_k1s_layout(params.poly_size, params.glwe_dim + 1,
                                 params.bsk_level, n_limbs, plan.cb,
                                 plan.cluster, plan.nt, plan.passes,
                                 ctypes.byref(smem), ctypes.byref(clusters)),
              lib)
    return smem.value, clusters.value


def _plain_slices(otf: bool, b_init, a_t, test_polys, kernels,
                  params: TFHEParams, batch_tile: int | None):
    plain = blind_rotate_k1_plain if otf else blind_rotate_k2_plain
    batch = test_polys.shape[0]
    step = batch_tile or max(batch, 1)
    outs = [plain(b_init[s:s + step], a_t[:, s:s + step],
                  test_polys[s:s + step], kernels, params)
            for s in range(0, batch, step)] or \
        [_init_acc(b_init, test_polys, params)]
    return torch.cat(outs, dim=1)


def blind_rotate_k2(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None,
                    cluster: int | None = None) -> torch.Tensor:
    """K2 ("fused"): keys [n, L·(k+1)·N, rows·N] int8 -> ACC [k+1, B, N].

    ``batch_tile``: ciphertexts per tile (CPU: per plain slice; CUDA: per
    cluster, one of ``K2_TILES``); ``cluster``: CTAs per tile.  Both
    default to :func:`k2_plan`'s choice."""
    if test_polys.device.type != "cpu":
        return _launch_k2(b_init, a_t, test_polys, kernels, params,
                          batch_tile, cluster)
    return _plain_slices(False, b_init, a_t, test_polys, kernels, params,
                         batch_tile)


def blind_rotate_k1(b_init, a_t, test_polys, kernels, params: TFHEParams,
                    batch_tile: int | None = None,
                    cluster: int | None = None,
                    nw: int | None = None,
                    route: str | None = None,
                    hankel: Callable[[], torch.Tensor] | None = None,
                    pair: int | None = None) -> torch.Tensor:
    """K1 ("fused_otf"): keys [n, L·(k+1), rows, 2N] int8 -> ACC.

    ``batch_tile``: ciphertexts per tile (CPU: per plain slice; CUDA: per
    cluster, one of ``K1_TILES``, or K1S_TILE for the small-N kernel);
    ``cluster``: CTAs per tile; ``nw``: coefficients per warpgroup, one of
    ``K1_WIDTHS``.  All default to :func:`k1_plan`'s choice, which at N <
    K1_SLICE is the small-N kernel's (:func:`k1_small_plan`: tiles of
    K1S_TILE, a cluster of :func:`k1s_clusters`, no ``nw``) and above it
    the plan of ``route`` (K1_ROUTES), by default the ring kernel's.
    ``hankel``: gives the keys' table, which a ring launch reads
    (:func:`k1_operand`; without it the launch builds one); ``pair``: the
    ring's tiles a cluster (K1_PAIRS), by default :func:`k1_ring_plan`'s."""
    if test_polys.device.type != "cpu":
        return _launch_k1(b_init, a_t, test_polys, kernels, params,
                          batch_tile, cluster, nw, route=route,
                          hankel=hankel, pair=pair)
    return _plain_slices(True, b_init, a_t, test_polys, kernels, params,
                         batch_tile)


def blind_rotate_fused(b_init, a_t, test_polys, kernels, params: TFHEParams,
                       batch_tile: int | None = None,
                       launch: profiling.Launch | None = None,
                       route: str | None = None,
                       cluster: int | None = None,
                       hankel: Callable[[], torch.Tensor] | None = None
                       ) -> torch.Tensor:
    """All-steps-fused blind rotation -> accumulator [k+1, B, N] int32.

    ``b_init``: [B, 1] int32 initial amounts ((2N − b~) mod 2N); ``a_t``:
    [n, B, 1] int32 per-step amounts in [0, 2N); ``test_polys``: [B, N]
    int32; ``kernels``: K2's [n, L·(k+1)·N, rows·N] or K1's
    [n, L·(k+1), rows, 2N] int8.  ``batch_tile``: ciphertexts per tile
    (CPU: per slice; CUDA: per cluster, default chosen by :func:`k1_plan`
    or :func:`k2_plan`); the last tile may be ragged.  ``launch``: the
    family call's entry of the launch record, made at the launch
    (:func:`..utils.profiling.launch`).  ``route``: K1's at N ≥ K1_SLICE
    and ``hankel``, what gives its keys' table (:func:`blind_rotate_k1`);
    ``cluster``: CTAs a tile on the card."""
    with profiling.launch(launch):
        if kernels.ndim == 4:
            return blind_rotate_k1(b_init, a_t, test_polys, kernels, params,
                                   batch_tile, cluster, None, route, hankel)
        return blind_rotate_k2(b_init, a_t, test_polys, kernels, params,
                               batch_tile, cluster)
