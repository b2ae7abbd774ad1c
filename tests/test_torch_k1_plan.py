"""K1's launch plan, the reversed-digit Hankel layout of its key operand, and
a plain emulation of its CUDA schedule; the table of H blocks it copies.

``k1_plan`` is checked at every preset, at the staged families' shapes and
at native p32, for the main path's batch sizes.  The emulation runs the
kernel's schedule in plain torch: clusters of CTAs that each own a slice of
the (k+1)·N output coefficients and write the digits of their coefficients
reversed within each row into a shared scratch; per chunk and K1_SLICE-byte
contraction slice, the H blocks copied from the keys' table (a run of
blocks from (t_c + j0')/8) and the key tile read out of them the way the
no-swizzle ``wgmma`` descriptors address them; int32 partial sums; the limb
combine.  It is held bitwise against ``blind_rotate_k1_plain`` and the JAX
``_kernel_otf`` in interpret mode, including limb drop and a ragged last
tile."""

import difflib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.optimizer import runtime_model as RM
from tfhe_fbs_map_tpu_torch.tfhe.params import (PRESETS, STAGED_PRESETS,
                                                TFHEParams)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

SMS = 132
MASK = (1 << 32) - 1
BATCHES = (1, 21, 64, 512, 1024, 2048)


def shape(k, N, l, b):
    return TFHEParams(p=4, lwe_dim=8, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=b, ksk_level=1, ksk_base_log=2,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


# every preset, the staged p32 pipeline's two families, native p32, and
# the (1, 4096) shape of the optimizer's grid (chip_smoke.py phase 11 (a))
SHAPES = {**{name: p for name, (p, _) in PRESETS.items()},
          "fam1": shape(1, 1024, 3, 6), "fam2": shape(2, 512, 4, 5),
          "p32": shape(1, 2048, 3, 7), "n4096": shape(1, 4096, 2, 8)}


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_fits_the_card(name, batch):
    params = SHAPES[name]
    assert fbr.unsupported(params, otf=True) is None
    kn = (params.glwe_dim + 1) * params.poly_size
    for limbs in (4, 3, 1):
        # on the route the cost model prices (tests/test_torch_k1_small_n.py)
        route = RM.k1_route(params, batch, limbs)
        plan = fbr.k1_plan(batch, params, SMS, limbs, route=route)
        if isinstance(plan, fbr.K1SmallPlan):
            # the small-tile plan, where the calibration prices it lower;
            # one wave of clusters a tile
            assert route == "k1s"
            assert plan.cluster in fbr.k1s_clusters(params, limbs, plan.cb)
            assert plan.cb in fbr.K1S_WIDE_TILES and plan.passes == 1
            continue
        assert route == "k1"
        assert plan.cb in fbr.K1_TILES and plan.nw in fbr.K1_WIDTHS
        assert fbr.k1_fits(plan.cb, plan.nw, limbs)
        assert 1 <= plan.cluster <= fbr.K1_MAX_CLUSTER
        # each CTA's slice is a whole number of chunks inside one component
        assert kn % (plan.cluster * 2 * plan.nw) == 0
        assert params.poly_size % (2 * plan.nw) == 0
        tiles = -(-batch // plan.cb)
        assert 0 < batch - (tiles - 1) * plan.cb <= plan.cb
        # one wave of CTAs, one an SM, each cluster one tile or two
        assert plan.pair in fbr.K1_PAIRS
        assert -(-tiles // plan.pair) * plan.cluster <= SMS


# Clusters the H100 runs at once with one CTA an SM, by cluster size
# (cudaOccupancyMaxActiveClusters for K1 on an H100 80GB HBM3, either
# schedule)
H100 = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 8: 15, 10: 7, 12: 7,
        16: 7}


def test_plan_keeps_one_wave_of_resident_clusters():
    """A 1024-ciphertext level takes 16 tiles of 64 on clusters of 6, one
    tile a cluster: no pair plan runs its 8 clusters in one wave but on
    clusters of 6, which leave half the card idle."""
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k1_ring_plan(1024, params, SMS,
                            resident=lambda p: H100[p.cluster])
    assert plan == (64, 6, 64, 1)
    for batch in BATCHES:
        for plan in (fbr.k1_ring_plan(batch, params, SMS,
                                      resident=lambda p: H100[p.cluster]),
                     fbr.k1_plan(batch, params, SMS,
                                 resident=lambda p: H100[p.cluster])):
            clusters = -(-(-(-batch // plan.cb)) // plan.pair)
            assert clusters <= H100[plan.cluster]


@pytest.mark.parametrize("family, batch, want", [
    # AES-128: 5-7 tiles fill the card's 7 clusters of 12 alone, one tile
    # each
    ("aes", 320, (64, 12, 64, 1)), ("aes", 448, (64, 12, 64, 1)),
    # 8-14 tiles: pairs on 4-7 clusters of 12 (an odd count runs its last
    # tile alone), where one tile a cluster takes clusters of 6, twice the
    # span
    ("aes", 512, (64, 12, 64, 2)), ("aes", 576, (64, 12, 64, 2)),
    ("aes", 896, (64, 12, 64, 2)),
    # 15-16 tiles: 8 clusters of 12 would take two waves
    ("aes", 960, (64, 6, 64, 1)), ("aes", 1024, (64, 6, 64, 1)),
    # 32 tiles: one wave of 16 pairs on clusters of 6 against two of one
    ("aes", 2048, (64, 6, 64, 2)),
    # Kreyvium's fam1: 36 tiles, 3 waves of pairs on clusters of 16 against
    # 6 of one tile; 48 tiles fill 7 waves of one tile, where pairs take 4
    # (or one on clusters of 4, four times the span)
    ("fam1", 2304, (64, 16, 64, 2)), ("fam1", 3072, (64, 16, 64, 1)),
    ("fam1", 3200, (64, 4, 64, 2))])
def test_pairs_take_the_launches_they_fit_in_fewer_waves(family, batch,
                                                         want):
    params = {"aes": PRESETS["aes128_p4"][0],
              "fam1": STAGED_PRESETS["kreyvium_p10_staged"].fam1}[family]
    plan = fbr.k1_ring_plan(batch, params, SMS,
                            resident=lambda p: H100[p.cluster])
    assert plan == want
    tiles = -(-batch // plan.cb)
    clusters = -(-tiles // plan.pair)
    # an odd tile count: the last cluster carries one tile
    if plan.pair == 2:
        assert tiles - 2 * (clusters - 1) in (1, 2)
        assert (tiles % 2 == 1) == (tiles - 2 * (clusters - 1) == 1)
    # the cost the plan takes it by: waves × span × cb × (64 + nw) / nw,
    # times K1_PAIR_COST for pairs; the other schedule costs no less
    kn = (params.glwe_dim + 1) * params.poly_size
    other = fbr.k1_ring_plan(batch, params, SMS, pair=3 - plan.pair,
                             resident=lambda p: H100[p.cluster])

    def cost(p):
        waves = -(-(-(-tiles // p.pair)) // H100[p.cluster])
        c = waves * (kn // p.cluster) * p.cb * (64 + p.nw) / p.nw
        return c * fbr.K1_PAIR_COST if p.pair == 2 else c
    assert cost(plan) <= cost(other)


# the fewest ring stages the kernel leaves beside a whole column chunk's
# staging buffer (``kWholeStages`` in csrc/fused_blind_rotate.cu)
WHOLE_STAGES = 4


def stage_smem(limbs, cb, nw):
    """Shared memory a CTA of the ring kernel takes at (limbs, cb, nw), as
    its source lays it out (``Stage`` in csrc/fused_blind_rotate.cu): ring
    stages of two 128-byte columns of cb digit rows and L limbs of H
    blocks, each rounded up to 1 KB, and the staging buffer of a column
    chunk's cb × 2·nw uint32 sums, whole where that leaves WHOLE_STAGES
    stages, else half; as many stages as fit beside it, 2 KB (alignment,
    mbarriers) and 1 KB of static arrays, at most 6.  Returns the bytes,
    the stages and the staging buffer's parts."""
    kA = 2 * cb * 128
    kH = limbs * h_blocks(nw) * 128
    stage = -(-(kA + kH) // 1024) * 1024
    room = fbr.SMEM_MAX - 2048 - 1024
    whole = cb * 2 * nw * 4
    parts = 1 if (room - whole) // stage >= WHOLE_STAGES else 2
    staging = whole // parts
    stages = min(6, (room - staging) // stage)
    return stages * stage + staging + 2048, stages, parts


@pytest.mark.parametrize("limbs, cb, nw", [
    (limbs, cb, nw) for limbs in (1, 2, 3, 4) for cb in fbr.K1_TILES
    for nw in fbr.K1_WIDTHS if fbr.k1_fits(cb, nw, limbs)])
def test_pair_plans_fit_shared_memory(limbs, cb, nw):
    """A cluster carrying two tiles keeps one ring: the pair plan of every
    (limbs, cb, nw) the kernel is built for takes the single-tile plan's
    shared memory, and the 4 mbarriers of its two tiles' cluster barriers
    fit the bytes beside the ring with the staging buffer's 2.  The ring
    keeps at least four stages beside the staging buffer, which holds a
    column chunk's sums whole or in two parts of whole 8 KB boxes (64 rows
    × 32 uint32 columns) of each warpgroup, 1 KB-aligned for TMA's 128B
    swizzle; a tile of 64 at nw = 32 (16 KB) is staged whole."""
    smem, stages, parts = stage_smem(limbs, cb, nw)
    assert 4 <= stages and smem + 1024 <= fbr.SMEM_MAX
    assert 1023 + 8 * (3 * 6 + 2 + 4) <= 2048
    boxes = cb // 64 * nw // 32  # a warpgroup's boxes a chunk
    assert parts in (1, 2) and boxes % parts == 0
    staging = 2 * boxes * 64 * 32 * 4 // parts
    assert staging % 1024 == 0 and staging >= 16384
    if (cb, nw) == (64, 32):
        assert parts == 1
    # the cells' plan stages a whole chunk beside four stages (five beside
    # half of one)
    if (limbs, cb, nw) == (4, 64, 64):
        assert (stages, parts) == (4, 1)
    params = PRESETS["aes128_p4"][0]
    for pair in fbr.K1_PAIRS:
        plan = fbr.k1_ring_plan(1024, params, SMS, limbs, cb=cb, nw=nw,
                                pair=pair)
        assert plan.pair == pair


def test_plan_overrides_and_refusals():
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k1_plan(1024, params, SMS, cb=128, cluster=3, nw=32)
    assert (plan.cb, plan.cluster, plan.nw) == (128, 3, 32)
    assert fbr.k1_plan(1024, params, SMS, cluster=12, pair=2) \
        == (64, 12, 64, 2)
    with pytest.raises(ValueError):
        fbr.k1_ring_plan(1024, params, SMS, pair=3)
    assert fbr.k1_clusters(params, 32) == [12, 8, 6, 4, 3, 2, 1]
    assert fbr.k1_clusters(params, 64) == [12, 6, 4, 3, 2, 1]
    # 128 ciphertexts × 4 limbs × 64 coefficients would take 256 registers
    assert not fbr.k1_fits(128, 64, 4) and fbr.k1_fits(128, 64, 2)
    with pytest.raises(ValueError):
        fbr.k1_plan(1024, params, SMS, cb=128, nw=64)
    # a cluster that does not split the coefficients into whole chunks
    with pytest.raises(ValueError):
        fbr.k1_plan(1024, params, SMS, cluster=5)
    # below K1_SLICE the small-N kernel serves a power of two from 32 up
    # (tests/test_torch_k1_small_n.py); 16 and a non-power of two are not
    small = TFHEParams(**{**vars(params), "poly_size": 128})
    assert small.poly_size < fbr.K1_SLICE
    assert fbr.unsupported(small, otf=True) is None
    for n, why in ((16, "multiple of 32"), (96, "power of two")):
        got = fbr.unsupported(TFHEParams(**{**vars(params), "poly_size": n}),
                              otf=True)
        assert why in got
    wide = TFHEParams(**{**vars(params), "poly_size": 1 << 15})
    assert "overflow" in fbr.unsupported(wide, otf=True)
    # served up to the largest N the card checks it at: chip_smoke.py phase
    # 11 (a) holds it bitwise at N=4096
    assert fbr.K1_MAX_N == 4096
    for n, why in ((2048, None), (4096, None), (8192, "checked at")):
        got = fbr.unsupported(TFHEParams(**{**vars(params), "poly_size": n}),
                              otf=True)
        assert got is None if why is None else why in got


# ------------------------------------------------- the Hankel key operand

def h_blocks(nw):
    """K1's H blocks a limb per ring stage (``Stage::kHB`` in its CUDA
    source): the 128-byte blocks that one K1_SLICE-byte contraction slice of
    a 2·nw-coefficient chunk touches, (2·nw − 8 + K1_SLICE − 16) / 8 + 1."""
    return (2 * nw + fbr.K1_SLICE) // 8 - 2


def test_reversed_digits_make_a_hankel_matrix_of_h_blocks():
    """D·M = D_rev·B'ᵀ with B'[t, j'] = E[t+j'+1], and every 8×16 core
    matrix of B' at (t0, j0') is the H block w = (t0+j0')/8."""
    rng = np.random.default_rng(0)
    N = 128
    E = rng.integers(-128, 128, 2 * N).astype(np.int64)
    D = rng.integers(-128, 128, (5, N)).astype(np.int64)
    j, t = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    M = E[N + t - j]                                       # [j, t]
    Bp = E[t + j + 1]                                      # [t, j'] (sym.)
    assert np.array_equal(D @ M, D[:, ::-1] @ Bp.T)
    blocks = 2 * N // 8 - 2
    H = np.stack([[E[8 * w + i + 1:8 * w + i + 17] for i in range(8)]
                  for w in range(blocks)])                 # [w, 8, 16]
    for t0 in range(0, N, 8):
        for j0 in range(0, N, 16):
            core = Bp[t0:t0 + 8, j0:j0 + 16]
            assert np.array_equal(core, H[(t0 + j0) // 8])


def test_h_block_builder_reads_only_the_extension():
    """The kernel copies a stage's blocks of one limb as the table's run
    from o0/8 (o0 = t_c + j0'); for every chunk and slice the run ends
    inside its (step, limb, comp, row)'s 2N/8 blocks, and the last byte of
    E it holds is inside the extension (no run reaches the table's zeros
    past 2N)."""
    for name, params in SHAPES.items():
        N = params.poly_size
        for nw in fbr.K1_WIDTHS:
            cw = 2 * nw
            o0 = (N - cw) + (N - fbr.K1_SLICE)     # the largest offset
            assert o0 % 16 == 0
            assert o0 // 8 + h_blocks(nw) <= 2 * N // 8, name
            last = o0 + 8 * h_blocks(nw) + 15
            assert last == 2 * N - 1, name


def old_producer_run(e, o0, hb):
    """The H blocks the ring kernel's producer built before the table, as
    its CUDA source cut them: the extension bytes E[o0 .. o0+8·hb+16)
    (read past 2N as the next row's slack; zeros here), and row ii of block
    w funnel-shifted out of the 4-byte words around 8w+ii+1."""
    buf = np.zeros(8 * hb + 24, dtype=np.uint8)
    got = e[o0:o0 + 8 * hb + 16].view(np.uint8)
    buf[:len(got)] = got
    words = buf[:len(buf) // 4 * 4].view("<u4").astype(np.uint64)
    out = np.zeros((hb, 8, 16), dtype=np.uint8)
    for ii in range(8):
        for w in range(hb):
            off = 8 * w + ii + 1
            src, sh = off // 4, 8 * (off % 4)
            for c in range(4):
                v = ((words[src + c] | (words[src + c + 1] << 32)) >> sh) \
                    & 0xFFFFFFFF
                out[w, ii, 4 * c:4 * c + 4] = np.array(
                    [v], dtype="<u4").view(np.uint8)
    return out.view(np.int8)


@pytest.mark.parametrize("limbs", [4, 3])
def test_hankel_table_is_the_old_producers_blocks(limbs):
    """The ring kernel's table holds, block for block, the rows its
    producer used to cut at every stage: row i of block w of the run at o0
    is E[o0+8w+i+1 ..+16), at every (limb, comp, row) and at the offsets
    of both edges (the first chunk's first slice, the last chunk's last)
    and between; every block also matches E[8w+i+1 ..+16) with zeros past
    2N, and the table is 16x the keys' bytes."""
    params = PRESETS["test"][0]
    N, k1 = params.poly_size, params.glwe_dim + 1
    rows = k1 * params.bsk_level
    rng = np.random.default_rng(limbs)
    keys = rng.integers(-128, 128, (2, limbs * k1, rows, 2 * N),
                        dtype=np.int8)
    before = dict(fbr.HANKEL)
    table = fbr.hankel_table(torch.from_numpy(keys)).numpy()
    assert table.shape == (2, limbs * k1, rows, 2 * N // 8, 128)
    assert fbr.HANKEL == {"tables": before["tables"] + 1,
                          "bytes": before["bytes"] + 16 * keys.size}
    pad = np.concatenate([keys, np.zeros(keys.shape[:-1] + (16,),
                                         dtype=np.int8)], axis=-1)
    idx = (np.arange(2 * N // 8)[:, None, None] * 8
           + np.arange(8)[None, :, None] + 1 + np.arange(16))
    assert np.array_equal(table, pad[..., idx].reshape(table.shape))
    for nw in fbr.K1_WIDTHS:
        hb = h_blocks(nw)
        edge = (N - 2 * nw) + (N - fbr.K1_SLICE)
        for o0 in sorted({0, 16, edge // 2 // 16 * 16, edge}):
            for lc in range(limbs * k1):
                for r in range(rows):
                    run = table[1, lc, r, o0 // 8:o0 // 8 + hb]
                    assert np.array_equal(
                        run.reshape(hb, 8, 16),
                        old_producer_run(keys[1, lc, r], o0, hb)), \
                        (nw, o0, lc, r)


def test_only_a_ring_launch_builds_the_table():
    """A K1 launch reads the compact keys on the small-N kernel's plans and
    the keys' table on the ring's: a key whose launches never take the
    ring builds none (``HANKEL`` unchanged), and one whose launches do
    builds one, once, kept by its ``FastKeys``."""
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import FastKeys
    params = AES
    k1, N = params.glwe_dim + 1, params.poly_size
    keys = torch.randint(-128, 128, (2, 4 * k1, k1 * params.bsk_level,
                                     2 * N), dtype=torch.int8)
    fast = FastKeys(params, keys, torch.zeros(8, 8, dtype=torch.int8),
                    "fused_otf")
    before = dict(fbr.HANKEL)
    small = fbr.k1_plan(16, params, SMS, route="k1s")
    assert isinstance(small, fbr.K1SmallPlan)
    for _ in range(3):
        assert fbr.k1_operand(small, keys, fast.hankel) is keys
    assert fbr.HANKEL == before and fast._hankel is None
    ring = fbr.k1_plan(1024, params, SMS, route="k1")
    assert isinstance(ring, fbr.K1Plan)
    table = fbr.k1_operand(ring, keys, fast.hankel)
    assert table.shape == (*keys.shape[:-1], 2 * N // 8, 128)
    assert fbr.k1_operand(ring, keys, fast.hankel) is table
    assert fast.hankel() is table
    assert fbr.HANKEL == {"tables": before["tables"] + 1,
                          "bytes": before["bytes"] + table.numel()}
    # a table of other keys is refused
    with pytest.raises(ValueError):
        fbr.k1_operand(ring, keys[:1], fast.hankel)


# ------------------------------------------------ emulation of the kernel

def emulate_k1(b_init, a_t, tvs, keys, params, plan):
    """K1's CUDA schedule in plain torch; keys [n, L·(k+1), rows, 2N]."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    rows = k1 * l
    K, kn = rows * N, k1 * N
    L = keys.shape[1] // k1
    batch = tvs.shape[0]
    cb, C, nw = plan.cb, plan.cluster, plan.nw
    cw, hb, kc = 2 * nw, h_blocks(nw), fbr.K1_SLICE
    tiles, span, nk = -(-batch // cb), kn // C, K // kc
    brows = torch.arange(batch)

    # where each B element of a (chunk, slice) sits in the stage's H blocks:
    # warpgroup wg = t // nw; core matrix (t_rel // 8, k // 16) at block
    # wg·nw/8 + t_rel//8 + 2·(k//16) (128 B along N, 256 B along K)
    t = torch.arange(cw)[:, None]
    k = torch.arange(kc)[None, :]
    block = (t // nw) * (nw // 8) + (t % nw) // 8 + 2 * (k // 16)
    h_index = block * 128 + (t % 8) * 16 + k % 16           # [cw, kc]
    assert int(block.max()) == hb - 1

    def rotated(vals, q, amt):
        c, tt = q // N, q % N
        am = amt & (N - 1)
        src = (tt[None, :] - am[:, None]) & (N - 1)
        v = vals[c[None, :], brows[:, None], src]
        neg = (tt[None, :] < am[:, None]) ^ ((amt & N) != 0)[:, None]
        return torch.where(neg, (-v) & MASK, v)

    acc = torch.zeros((k1, batch, N), dtype=torch.int64)
    src = torch.zeros_like(acc)
    src[k1 - 1] = tvs.long() & MASK
    acc[k1 - 1] = rotated(src, torch.arange((k1 - 1) * N, kn),
                          b_init[:, 0].long())

    bl, half = b * l, 1 << (b - 1)
    table = fbr.hankel_table(keys).long()
    for i in range(a_t.shape[0]):
        amt = a_t[i, :, 0].long()
        dig = torch.zeros((tiles * cb, K), dtype=torch.int64)
        for r in range(C):  # each CTA: reversed digits of its coefficients
            q = torch.arange(r * span, (r + 1) * span)
            c, tt = q // N, q % N
            diff = (rotated(acc, q, amt) - acc[c[None, :], brows[:, None],
                                               tt[None, :]]) & MASK
            w = ((diff + (1 << (31 - bl))) & MASK) >> (32 - bl)
            w = w + sum(half << (b * j) for j in range(l))
            for lev in range(l):
                d = ((w >> (b * (l - 1 - lev))) & ((1 << b) - 1)) - half
                dig[:batch, (c * l + lev) * N + N - 1 - tt] = d
        for tile in range(tiles):
            for r in range(C):
                for ch in range(span // cw):
                    q0 = r * span + ch * cw
                    comp, tc = q0 // N, q0 % N
                    part = torch.zeros((L, cb, cw), dtype=torch.float64)
                    for s in range(nk):
                        x = s * kc
                        row, j0 = x // N, x % N
                        a = dig[tile * cb:(tile + 1) * cb, x:x + kc].double()
                        for lb in range(L):
                            # the stage's H blocks: the table's run of hb
                            # blocks from (tc + j0) / 8, one bulk copy
                            w0 = (tc + j0) // 8
                            h = table[i, lb * k1 + comp, row,
                                      w0:w0 + hb].reshape(-1)
                            part[lb] += a @ h[h_index].double().t()
                    # int32 sums: exact and in range
                    assert part.abs().max() < 2 ** 31
                    p = part.long() & MASK
                    add = sum((p[lb] << 8 * (lb + 4 - L)) & MASK
                              for lb in range(L))          # [cb, cw]
                    # the reduce-add, box by box: 64 rows × 32 columns of
                    # a warpgroup's, inside one component, added mod 2^32
                    # with the rows past the batch left out
                    for wg in range(2):
                        for m in range(cb // 64):
                            for j in range(nw // 32):
                                rows = tile * cb + 64 * m + torch.arange(64)
                                keep = rows < batch
                                box = wg * nw + 32 * j + torch.arange(32)
                                assert tc + int(box[-1]) < N
                                at = (comp, rows[keep][:, None],
                                      (tc + box)[None, :])
                                got = add[64 * m:64 * (m + 1)][keep][:, box]
                                acc[at] = (acc[at] + got) & MASK
    return ((acc + (1 << 31)) & MASK) - (1 << 31)


def k1_operands(params, steps, batch, limbs, seed):
    rng = np.random.default_rng(seed)
    k1, N = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (steps, batch, 1)).astype(np.int32)
    edges = np.array([0, N - 1, N, 2 * N - 1], dtype=np.int32)
    a_t[:, :4, 0] = edges
    b_init[:4, 0] = edges
    tvs = rng.integers(-2 ** 31, 2 ** 31, (batch, N)).astype(np.int32)
    keys = rng.integers(-128, 128, (steps, limbs * k1, rows, 2 * N),
                        dtype=np.int8)
    return b_init, a_t, tvs, keys


AES = PRESETS["aes128_p4"][0]
CASES = {  # label -> (params, steps)
    "test": (PRESETS["test"][0], PRESETS["test"][0].lwe_dim),
    "aes128_p4 n=4": (AES, 4),
}


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("limbs", [4, 3])
@pytest.mark.parametrize("plan_of", ["default", "cb=128 nw=32"])
def test_emulated_schedule_equals_plain_and_jax(label, limbs, plan_of):
    params, steps = CASES[label]
    batch = 21  # ragged: one tile of 64 or 128 holding 21 ciphertexts
    b_init, a_t, tvs, keys = k1_operands(params, steps, batch, limbs,
                                         seed=limbs)
    kw = {} if plan_of == "default" else {"cb": 128, "nw": 32}
    plan = fbr.k1_ring_plan(batch, params, SMS, limbs, **kw)
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs)))
    got = emulate_k1(*args, torch.from_numpy(keys), params, plan)
    plain = fbr.blind_rotate_k1_plain(*args, torch.from_numpy(keys), params)
    assert torch.equal(got.to(torch.int32), plain)
    if plan_of != "default":
        return
    jparams = J.TFHEParams(**vars(params))
    want = jfbr.blind_rotate_fused(
        jnp.asarray(b_init), jnp.asarray(a_t), jnp.asarray(tvs),
        jnp.asarray(keys), jparams, True)
    assert np.array_equal(np.asarray(want), plain.numpy())


def test_bisect_variants_remove_one_phase_each():
    """The phase bisect's source edits still find what they remove in K1's
    CUDA source: each variant differs from it, and in its own way."""
    from tfhe_fbs_map_tpu_torch.ops import _build
    from tfhe_fbs_map_tpu_torch.runtime import bisect

    src = (_build.CSRC / "fused_blind_rotate.cu").read_text()
    var = bisect.variants(src)
    assert var["base"] == src
    assert src.count("wgmma_s8<R>(") == 1
    assert "wgmma_s8<R>(" not in var["no_products"]
    assert "bulk_load(" not in var["no_h_copy"].split("copy_h = ")[1] \
        .split("};")[0]
    assert "hfull + 8 * s, (G / kS)" not in var["no_h_copy"]
    assert "wgmma_s8<R>(" not in var["no_products_no_h_copy"]
    assert "digit_pass<" not in var["no_digits"]
    # no_epilogue: the staging stores (kept only under odds of 2^-32, so
    # the sums and the products they read stay) and the reduce-add go;
    # every other line, the handshakes, fences and signals among them,
    # stays
    no_ep = var["no_epilogue"]
    assert src.count("tma_reduce_add(") == 1
    assert "tma_reduce_add(" not in no_ep
    assert "if (v0 == ~v1) st_shared_v2(" in no_ep
    gone = [ln for ln in difflib.ndiff(src.splitlines(), no_ep.splitlines())
            if ln.startswith("- ")]
    assert len(gone) == 3, gone
    assert "st_shared_v2(" in gone[0] and "tma_reduce_add(" in gone[1]
    for keep in ("mbar_arrive(rg.staged)", "mbar_arrive(rg.freed)",
                 "wait_group 0;", "signal_cluster(", "cluster_sync();",
                 "wait_group.read"):
        assert no_ep.count(keep) == src.count(keep) > 0, keep
    assert len({text for text in var.values()}) == len(var)


def function(src, name):
    """The body of the CUDA function ``name``, from its definition (``void
    name(`` or, for a kernel, ``name(`` at the start of a line)."""
    start = re.search(rf"(?:void |\n){name}\(", src).start()
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[i:j + 1]
    raise ValueError(name)


def test_product_warps_never_touch_acc():
    """The ring kernels' product warpgroups hand a column chunk's sums to
    the staging buffer: ``chunk`` and ``stage_chunk`` issue no global load
    or store of ACC and no fence beyond the async proxy's, and the paired
    schedule's product branch runs ``chunk`` alone; the reduce-add, its
    drain and the cluster signals are another thread's."""
    from tfhe_fbs_map_tpu_torch.ops import _build

    src = (_build.CSRC / "fused_blind_rotate.cu").read_text()
    for name in ("chunk", "stage_chunk"):
        body = function(src, name)
        for banned in ("__ldcg", "__stcg", "__threadfence", "acc[",
                       "signal_cluster", "cluster_sync", "reduce_block",
                       "tma_reduce_add", "fence.proxy.async.global"):
            assert banned not in body, (name, banned)
    assert "stage_chunk<L, CB, NW>(" in function(src, "chunk")
    pair = function(src, "k1_kernel_pair")
    products = pair[pair.index("---- product warpgroups"):]
    products = products[:products.index("cluster_sync();  // no CTA leaves")]
    assert "init_acc" not in products and "signal_cluster" not in products
    assert "chunk<L, CB, NW>(" in products and "reduce_" not in products
    # the reduce-adds complete, then both fences, before any signal
    red = function(src, "reduce_block")
    assert red.index("tma_reduce_add(") < red.index("wait_group 0") \
        < red.index("fence.proxy.async.global") < red.index("__threadfence")
