"""K1 at N = 32, 64 and 128, the rings its 256-byte contraction slices do not
divide: its serving rule, the small-N kernel's launch plan, and a plain
emulation of that kernel's CUDA schedule.

``blind_rotate_k1_plain`` is held bitwise against the JAX ``_kernel_otf``
in interpret mode (which takes any N, with its strip tile min(128, N)) at
N ∈ {32, 64, 128}, k ∈ {1, 2}, l ∈ {2, 3} at 4 and 3 limbs, on a ragged
batch of 21.  The emulation runs ``csrc/fused_blind_rotate_k1_small.cu``'s
schedule in plain torch: tiles of 16 ciphertexts, per step and input
component the digits written reversed within each row and the step's E rows
of that component, the Hankel key operand read as 4-byte windows of E, one
int32 fragment a (limb, n8 tile) over the whole contraction on the warp
that owns the tile, then the limb combine; it is held bitwise against the
plain version.  The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py`` phase 12 (a) and ``tests/test_torch_gpu.py``."""

import dataclasses
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu_torch import bench, bench_multichip
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.optimizer import runtime_model
from tfhe_fbs_map_tpu_torch.optimizer.optimizer import calibration
from tfhe_fbs_map_tpu_torch.parallel.dryrun import DRYRUN_PARAMS
from tfhe_fbs_map_tpu_torch.tfhe.params import (PRESETS, STAGED_PRESETS,
                                                TFHEParams)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

MASK = (1 << 32) - 1
BATCHES = (1, 21, 64, 512, 2048)
SMALL_N = (32, 64, 128)


def shape(k, N, l, b):
    return TFHEParams(p=4, lwe_dim=8, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=b, ksk_level=1, ksk_base_log=2,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def base_log(l):
    """b = 8 at l = 2, 7 at l = 3 (b·l < 32)."""
    return 8 if l == 2 else 7


# the JAX package's own small-N families, as the port's modules that run
# them hold them: the dry run's (__graft_entry__.py _tiny_setup), the
# staged dry run's fam2, bench --quick's and bench_multichip --quick's
JAX_SHAPES = {"dryrun N=64": DRYRUN_PARAMS,
              "staged fam2 N=128": STAGED_PRESETS["staged_test"].fam2,
              "bench --quick N=128": bench.QUICK_PARAMS,
              "bench_multichip --quick N=128": bench_multichip.QUICK_PARAMS}

# the small-N kernel's source, which sizes its shared memory itself
K1S_SOURCE = (Path(fbr.__file__).parent / "csrc"
              / "fused_blind_rotate_k1_small.cu").read_text()


def source_constant(name: str) -> int:
    """``constexpr int name = value;`` of the small-N kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         K1S_SOURCE).group(1))


def operands(params, steps, batch, limbs, seed):
    """Random kernel operands from a numpy seed, with the rotation amounts'
    edge cases 0, N-1, N and 2N-1 in every step."""
    rng = np.random.default_rng(seed)
    k1, N = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (steps, batch, 1)).astype(np.int32)
    edges = np.array([0, N - 1, N, 2 * N - 1], dtype=np.int32)[:batch]
    a_t[:, :4, 0] = edges
    b_init[:4, 0] = edges
    tvs = rng.integers(-2 ** 31, 2 ** 31, (batch, N)).astype(np.int32)
    keys = rng.integers(-128, 128, (steps, limbs * k1, rows, 2 * N),
                        dtype=np.int8)
    return b_init, a_t, tvs, keys


# ------------------------------------------------- against the JAX kernel

@pytest.mark.parametrize("N", SMALL_N)
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("l", [2, 3])
@pytest.mark.parametrize("limbs", [4, 3])
def test_plain_equals_jax_interpret(N, k, l, limbs):
    params = shape(k, N, l, base_log(l))
    assert fbr.unsupported(params, otf=True) is None
    b_init, a_t, tvs, keys = operands(params, 3, 21, limbs, seed=N + k + l)
    want = jfbr.blind_rotate_fused(
        jnp.asarray(b_init), jnp.asarray(a_t), jnp.asarray(tvs),
        jnp.asarray(keys), J.TFHEParams(**vars(params)), True)
    got = fbr.blind_rotate_k1_plain(
        *map(torch.from_numpy, (b_init, a_t, tvs, keys)), params)
    assert got.shape == (k + 1, 21, N)
    assert np.array_equal(np.asarray(want), got.numpy())


# ------------------------------------------------------ serving and plan

@pytest.mark.parametrize("name", sorted(PRESETS))
@pytest.mark.parametrize("batch", BATCHES)
def test_presets_stay_on_the_n256_kernel(name, batch):
    """Every preset has N ≥ 256: K1 serves it with its ring kernel, or
    where the calibration's own points of it price it lower its small-tile
    plan (never its small-N plan), on the route, tile and cluster the cost
    model chooses; the ring kernel's plan is unchanged."""
    params = PRESETS[name][0]
    assert params.poly_size >= fbr.K1_SLICE
    assert fbr.unsupported(params, otf=True) is None
    c = runtime_model.launch_choice(params, batch, 1, "fused_otf")
    cb, cluster = c.tile or (None, None)
    plan = fbr.k1_plan(batch, params, 132, 4, cb, cluster, route=c.route)
    ring = fbr.k1_ring_plan(batch, params, 132)
    assert ring.cb in fbr.K1_TILES and ring.nw in fbr.K1_WIDTHS
    if runtime_model.small_tile_wins(params, batch):
        assert c.route == c.path == "k1s"
        assert plan == fbr.k1_wide_plan(batch, params, 132, 4, cluster,
                                        cb=cb)
        assert plan.cb in fbr.K1S_WIDE_TILES and plan.passes == 1
    else:
        assert (c.route, c.tile) == ("k1", None)
        assert plan == ring


SMALL_SHAPES = {**JAX_SHAPES, **{
    f"k={k} N={N} l={l}": shape(k, N, l, base_log(l))
    for k in (1, 2) for N in SMALL_N for l in (2, 3)}}


def owners(plan, kn, chunks, warps=fbr.K1S_WARPS, wide=False):
    """(column, contraction chunk) -> (CTA, warp) of every product the
    plan's CTAs and warps compute: CTA r the span [r·span, (r+1)·span),
    its ``warps`` warps groups of nt n8 tiles, as many as cover them
    rounded up to a power of two (at N ≥ 256, ``wide``, exactly as many),
    warp w group w % groups over slice w // groups of the ``chunks``
    32-byte chunks."""
    span = kn // plan.cluster
    tiles = span // 8
    groups = fbr.k1s_groups(span, plan.nt, wide)
    assert groups >= -(-tiles // plan.nt) and warps % groups == 0
    slices = warps // groups
    held = {}
    for r in range(plan.cluster):
        for w in range(warps):
            tg, ks = w % groups, w // groups
            for s in range(plan.nt):
                tile = tg * plan.nt + s
                if tile >= tiles:
                    continue
                for q in range(r * span + 8 * tile, r * span + 8 * tile + 8):
                    for kc in range(ks * chunks // slices,
                                    (ks + 1) * chunks // slices):
                        assert (q, kc) not in held
                        held[q, kc] = (r, w)
    return held


@pytest.mark.parametrize("name", sorted(SMALL_SHAPES))
@pytest.mark.parametrize("batch", BATCHES)
def test_small_plan_covers_the_columns(name, batch):
    """K1's plan below N=256 is the small-N kernel's, whatever the batch:
    tiles of 16 on the largest cluster it is built for, whose CTAs split
    the (k+1)·N columns into whole n8 tiles; every product (column,
    contraction chunk) is computed exactly once across the cluster's CTAs
    and warps, each warp holding all its CTA's tiles up to nt and a slice of
    the contraction; more than one CTA a tile; at l ≤ 3 one digit pass a
    step."""
    params = SMALL_SHAPES[name]
    assert fbr.unsupported(params, otf=True) is None
    k1, N, l = params.glwe_dim + 1, params.poly_size, params.bsk_level
    kn = k1 * N
    for limbs in (4, 3, 1):
        plan = fbr.k1_plan(batch, params, 132, limbs)
        assert plan == fbr.k1_small_plan(params, limbs)
        assert plan.cb == fbr.K1S_TILE == 16
        assert plan.cluster == fbr.k1s_clusters(params, limbs)[0] > 1
        span = kn // plan.cluster
        assert plan.nt in fbr.K1S_TILES_A_WARP
        assert plan.nt == next((t for t in fbr.K1S_TILES_A_WARP
                                if t >= span // 8), fbr.K1S_TILES_A_WARP[-1])
        chunks = k1 * l * N // 32
        held = owners(plan, kn, chunks)
        assert sorted(held) == [(q, kc) for q in range(kn)
                                for kc in range(chunks)]
        assert plan.passes == 1
        assert fbr.k1_small_smem(params, limbs, plan.cluster, 1) \
            <= fbr.SMEM_MAX
        tiles = -(-batch // plan.cb)
        assert 0 < batch - (tiles - 1) * 16 <= 16


@pytest.mark.parametrize("name", sorted(JAX_SHAPES))
@pytest.mark.parametrize("rows", BATCHES)
def test_model_prices_the_small_plan(name, rows):
    """The runtime model prices a small-N K1 call at the plan the card
    launches (``_launch_k1`` takes ``k1_device_plan``'s, which is
    ``k1_plan``'s): tiles of 16, a cluster of CTAs a tile, and waves of as
    many clusters as the calibrated card runs at once (one CTA an SM where
    the resident table has no entry)."""
    params = JAX_SHAPES[name]
    cal = calibration()
    plan, waves = runtime_model.launch_plan(params, rows, "fused_otf")
    assert isinstance(plan, fbr.K1SmallPlan)
    assert plan == fbr.k1_plan(rows, params, cal["sms"])
    resident = cal["resident"].get(
        runtime_model.resident_key("fused_otf", 4, plan, params),
        cal["sms"] // plan.cluster)
    assert waves == -(-(-(-rows // 16)) // resident)
    assert runtime_model.launch_us(params, rows, "fused_otf") > 0


def test_small_plan_at_the_largest_rows_fits_shared_memory():
    """b = 1 allows l = 31 (b·l < 32): the widest served small shapes, at
    every N and the most columns, still fit a CTA's shared memory as the
    host's copy of the kernel's layout counts it (``k1_small_smem``, on the
    source's own constants), one digit pass a component where the digits of
    all k+1 would not fit; ``tests/test_torch_gpu.py`` holds that copy to
    the built kernel's count."""
    assert source_constant("kCB") == fbr.K1S_TILE
    assert source_constant("kWarps") == fbr.K1S_WARPS
    assert source_constant("kMaxCluster") == fbr.K1S_MAX_CLUSTER
    assert [source_constant(c) for c in (
        "kAccPad", "kDigPad", "kEPad", "kRedPad")] == [
        fbr.K1S_ACC_PAD, fbr.K1S_DIG_PAD, fbr.K1S_E_PAD, fbr.K1S_RED_PAD]
    for N in SMALL_N:
        for k in range(1, fbr.K1S_MAX_KN // N):
            for l, b in ((31, 1), (5, 6), (3, 7), (2, 8)):
                params = shape(k, N, l, b)
                assert fbr.unsupported(params, otf=True) is None
                for limbs in (4, 3, 1):
                    for c in fbr.k1s_clusters(params, limbs):
                        plan = fbr.k1_small_plan(params, limbs, cluster=c)
                        assert fbr.k1_small_smem(
                            params, limbs, c, plan.passes) <= fbr.SMEM_MAX
                        one = fbr.k1_small_smem(params, limbs, c, 1)
                        assert plan.passes == (1 if one <= fbr.SMEM_MAX
                                               else k + 1)
    # the widest shapes run one pass a component
    for N in SMALL_N:
        k = fbr.K1S_MAX_KN // N - 1
        assert fbr.k1_small_plan(shape(k, N, 31, 1)).passes == k + 1


@pytest.mark.parametrize("N", SMALL_N)
@pytest.mark.parametrize("k", [1, 2])
def test_every_small_shape_is_served(k, N):
    """N ∈ {32, 64, 128}, k ∈ {1, 2}: every (l, b) is served under the same
    b ≤ 8, b·l < 32 and int32-sum rules as N ≥ 256, and refused past
    them."""
    for b in range(1, 10):
        for l in range(1, 33):
            got = fbr.unsupported(shape(k, N, l, b), otf=True)
            if b <= 8 and b * l < 32:
                assert got is None, (l, b)
            else:
                assert got is not None, (l, b)


@pytest.mark.parametrize("k,N,why", [
    (1, 16, "multiple of 32"),         # N = 16
    (1, 96, "power of two"),           # N not a power of two
    (2, 48, "multiple of 32"),
    (1, 384, "power of two"),
    (1, 8192, "checked at"),           # above K1_MAX_N
    (4, 128, f"> {fbr.K1S_MAX_KN}"),   # (k+1)·N above the small kernel's
])
def test_refused_shapes(k, N, why):
    got = fbr.unsupported(shape(k, N, 2, 8), otf=True)
    assert got is not None and why in got
    if N < fbr.K1_SLICE and N % 32 == 0 and not N & (N - 1):
        with pytest.raises(ValueError, match="n8 tiles"):
            fbr.k1_plan(64, shape(k, N, 2, 8), 132)


def test_small_launch_refuses_ring_knobs():
    """Tiles and widths are the N ≥ 256 kernel's knobs, and a cluster the
    small-N kernel is not built for (one that does not split the (k+1)·N
    columns into whole n8 tiles, more than K1S_MAX_CLUSTER CTAs, spans
    wider than K1S_MAX_SPAN, or a layout past a CTA's shared memory) is
    refused before the card is touched; a cluster it is built for is
    taken."""
    params = JAX_SHAPES["dryrun N=64"]   # (k+1)·N = 128
    assert fbr.k1s_clusters(params) == [8, 4, 2, 1]
    with pytest.raises(ValueError, match="no nw"):
        fbr.k1_plan(64, params, 132, cb=64)
    with pytest.raises(ValueError, match="no nw"):
        fbr.k1_plan(64, params, 132, nw=32)
    for bad in (3, 5, 16):
        with pytest.raises(ValueError, match="built for clusters"):
            fbr.k1_plan(64, params, 132, cluster=bad)
    wide = shape(3, 128, 2, 8)            # (k+1)·N = 512: spans ≤ 128
    assert fbr.k1s_clusters(wide) == [8, 4]
    for bad in (1, 2):
        with pytest.raises(ValueError, match="built for clusters"):
            fbr.k1_plan(64, wide, 132, cluster=bad)
    assert fbr.k1_plan(64, params, 132, cb=16, cluster=8) \
        == fbr.k1_small_plan(params)
    forced = fbr.k1_plan(64, params, 132, cluster=1)
    assert (forced.cluster, forced.nt) == (1, 4)     # four groups of 4 tiles
    assert len(owners(forced, 128, 8)) == 128 * 8
    big = shape(2, 128, 30, 1)                       # l = 30: spans of 48
    assert 8 not in fbr.k1s_clusters(big)            # do not fit at 8 CTAs
    with pytest.raises(ValueError, match="built for clusters"):
        fbr.k1_plan(64, big, 132, cluster=8)
    assert fbr.k1_plan(64, big, 132).cluster == 6


# ------------------------------------------------ emulation of the kernel

def u32_words(buf: torch.Tensor) -> torch.Tensor:
    """A byte buffer's little-endian 32-bit words, int64."""
    w = buf.long().reshape(-1, 4) & 0xFF
    return w[:, 0] | w[:, 1] << 8 | w[:, 2] << 16 | w[:, 3] << 24


def b_operand(words, at_gen, at_flat, flat):
    """The B fragment bytes [..., 32, span] as the kernel's warps read them,
    each window as the two aligned words around it, funnel-shifted
    (``window``); ``at_gen`` the byte each k row's window starts at as a
    tile's own (``bo[nt] + ko``, + 16 for its second register),
    ``at_flat`` as the group's where its tiles lie in one component
    (``bo[0] + ko + 8m``), which must agree on every flat column."""
    assert torch.equal(at_flat[..., flat], at_gen[..., flat])
    at = torch.where(flat, at_flat, at_gen)
    i = torch.arange(32)[:, None] % 4
    lo = at >> 2
    val = ((words[lo] | words[lo + 1] << 32) >> (8 * (at & 3))) & MASK
    byte = (val >> (8 * i)) & 0xFF
    return torch.where(byte >= 128, byte - 256, byte)


def emulate_small(b_init, a_t, tvs, keys, params, plan):
    """The small-N K1's CUDA schedule in plain torch; keys
    [n, L·(k+1), rows, 2N].  Every CTA of a tile's cluster keeps its own
    copy of the tile's ACC, double-buffered; a step's CTA computes its
    digits from its copy of buffer i&1 (all k+1 components in one pass, or
    one pass a component, as the plan says), its span's products from the
    key stage it copied, read as the warps read it (a group of nt n8 tiles
    in one component takes nt + 2 windows a chunk, any other tile two
    windows of its own; each window two aligned words), one int32 fragment
    sum a
    contraction slice (its warps' share of every pass's chunks), the
    slices' limb-shifted sums added mod 2^32, and stores its span of the
    new ACC into buffer (i+1)&1 of every copy."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    L = keys.shape[1] // k1
    batch, cb, C = tvs.shape[0], plan.cb, plan.cluster
    kn, rows = k1 * N, k1 * l
    span, passes = kn // C, plan.passes
    cpp, prow = k1 // passes, rows // passes
    bl, half = b * l, 1 << (b - 1)
    bufs = 2
    log_n = N.bit_length() - 1

    # every (column, chunk) product on exactly one (CTA, warp)
    chunks = prow * N // 32
    assert len(owners(plan, kn, chunks)) == kn * chunks
    slices = fbr.K1S_WARPS // fbr.k1s_groups(span, plan.nt)
    # a B fragment's bytes: column (comp, t), contraction k of a 32-wide
    # chunk at j0 reads E[t + j0 + k + 1]; as two aligned words a window it
    # reads at most 4 bytes past the row, inside the next row or kEPad
    top = (N - 1) + (N - 32) + 31 + 1
    assert (top & ~3) + 7 < 2 * N + source_constant("kEPad")
    # each lane's window starts: column q = q_lo + 8·tile + gid of tile nt
    # of group tg, k = 16·h + 4·tig + i
    nt = plan.nt
    cols = torch.arange(span)
    tile, gid = cols // 8, cols % 8
    tg, ntl = tile // nt, tile % nt
    kk = torch.arange(32)[:, None]
    hh, tig = kk // 16, (kk % 16) // 4

    def rotated(rows_, amt):
        """X^amt · rows, [cb, N] uint32 values in int64."""
        am = amt & (N - 1)
        src = (torch.arange(N)[None, :] - am[:, None]) & (N - 1)
        v = torch.gather(rows_, 1, src)
        neg = (torch.arange(N)[None, :] < am[:, None]) \
            ^ ((amt & N) != 0)[:, None]
        return torch.where(neg, (-v) & MASK, v)

    # every tile at once: rows [tiles·cb], those past the batch with zero
    # digits, never stored (the key operand does not depend on the tile)
    rows_all = -(-batch // cb) * cb
    live = torch.arange(rows_all) < batch
    tv = torch.zeros((rows_all, N), dtype=torch.int64)
    tv[:batch] = tvs.long() & MASK
    b0 = torch.zeros(rows_all, dtype=torch.int64)
    b0[:batch] = b_init[:, 0].long()
    # copies [CTA][buffer][row][(comp, t)]
    acc = torch.zeros((C, bufs, rows_all, kn), dtype=torch.int64)
    acc[:, 0, :, (k1 - 1) * N:] = rotated(tv, b0) * live[:, None]
    for i in range(a_t.shape[0]):
        cur, nxt = i % bufs, (i + 1) % bufs
        amt = torch.zeros(rows_all, dtype=torch.int64)
        amt[:batch] = a_t[i, :, 0].long()
        spans = []
        for r in range(C):
            q_lo = r * span
            q = q_lo + cols
            c_lo = q_lo // N
            nc = (q_lo + span - 1) // N - c_lo + 1
            bo = (((q >> log_n) - c_lo) * prow * 2 * N + (q & (N - 1))
                  + 4 * tig + 1)                              # [32, span]
            q_first = q_lo + 8 * tg * nt
            flat = (((tg + 1) * nt <= span // 8)
                    & ((q_first >> log_n) == ((q_first + 8 * nt - 1) >> log_n)))
            qf = q_first + gid
            bo0 = (((qf >> log_n) - c_lo) * prow * 2 * N + (qf & (N - 1))
                   + 4 * tig + 1)
            d = torch.zeros((slices, L, rows_all, span), dtype=torch.float64)
            for p in range(passes):
                dig = torch.zeros((rows_all, prow * N), dtype=torch.int64)
                for ci in range(cpp):
                    own = acc[r, cur, :, (p * cpp + ci) * N:][:, :N]
                    diff = (rotated(own, amt) - own) & MASK
                    w = ((diff + (1 << (31 - bl))) & MASK) >> (32 - bl)
                    w = w + sum(half << (b * j) for j in range(l))
                    for lev in range(l):
                        dl = ((w >> (b * (l - 1 - lev))) & ((1 << b) - 1)) \
                            - half
                        dig[:, (ci * l + lev) * N + N - 1
                            - torch.arange(N)] = dl * live[:, None]
                # the stage as the bulk copies lay it: [L][nc][prow][2N]
                # and kEPad bytes past it
                stage = torch.cat([torch.stack([
                    keys[i, lb * k1 + c_lo + c, p * prow:(p + 1) * prow]
                    for lb in range(L) for c in range(nc)]).reshape(-1),
                    torch.zeros(source_constant("kEPad"), dtype=torch.int8)])
                words = u32_words(stage)
                # every chunk and limb at once: [L, chunks, 32, span]
                kc = torch.arange(chunks)
                ko = (kc // (N // 32) * 2 * N + kc % (N // 32) * 32
                      )[None, :, None, None]
                ko = ko + (torch.arange(L) * nc * prow * 2 * N
                           )[:, None, None, None]
                bm = b_operand(words, ko + bo + 16 * hh,
                               ko + bo0 + 8 * (ntl + 2 * hh), flat).double()
                a = dig.reshape(rows_all, chunks, 32).double()
                for ks in range(slices):
                    lo = ks * chunks // slices
                    hi = (ks + 1) * chunks // slices
                    d[ks] += torch.einsum("gck,lcks->lgs", a[:, lo:hi],
                                          bm[:, lo:hi])
                # int32 fragment sums: exact and in range
                assert d.abs().max() < 2 ** 31
            add = sum((d[ks, lb].long() & MASK) << 8 * (lb + 4 - L)
                      for ks in range(slices) for lb in range(L)) & MASK
            spans.append((acc[r, cur][:, q] + add) & MASK)
        for r, new in enumerate(spans):
            acc[:, nxt, :, r * span:(r + 1) * span] = new * live[:, None]
    fin = a_t.shape[0] % bufs
    assert all(torch.equal(acc[r, fin], acc[0, fin]) for r in range(C))
    out = acc[0, fin, :batch]
    out = ((out + (1 << 31)) & MASK) - (1 << 31)
    return out.reshape(batch, k1, N).permute(1, 0, 2)


def emulate_wide(b_init, a_t, tvs, keys, params, plan):
    """K1's small-tile schedule at N ≥ 256 (``k1s_kernel_wide``) in plain
    torch; keys [n, L·(k+1), rows, 2N].  CTA r of a tile's cluster keeps
    only its span of the ACC; a step's CTA computes the digits of its span,
    8 coefficients an item, reading each item's rotated source words as
    three aligned 4-word blocks from the CTAs that own them (each block
    inside one owner's span), and stores them into every CTA's digits
    (together the whole tile's, each column written once); then the
    products of its span over all the digits and the step's rows in one
    pass, read as the warps read them (:func:`b_operand`), the slices'
    limb-shifted sums added into its span in place."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    L = keys.shape[1] // k1
    batch, cb, C = tvs.shape[0], plan.cb, plan.cluster
    kn, rows = k1 * N, k1 * l
    span, nt = kn // C, plan.nt
    assert plan.passes == 1 and span % 8 == 0
    bl, half = b * l, 1 << (b - 1)
    log_n = N.bit_length() - 1
    chunks = rows * N // 32
    warps = fbr.k1s_warps(params, cb)
    assert len(owners(plan, kn, chunks, warps, True)) == kn * chunks
    slices = warps // fbr.k1s_groups(span, nt, True)
    cols = torch.arange(span)
    tile, gid = cols // 8, cols % 8
    tg, ntl = tile // nt, tile % nt
    kk = torch.arange(32)[:, None]
    hh, tig = kk // 16, (kk % 16) // 4
    rows_all = -(-batch // cb) * cb
    live = torch.arange(rows_all) < batch
    g_idx = torch.arange(rows_all)[:, None, None]

    # each CTA's span [C][row][span], X^{b_init}·tv in the last component
    acc = torch.zeros((C, rows_all, span), dtype=torch.int64)
    b0 = torch.zeros(rows_all, dtype=torch.int64)
    b0[:batch] = b_init[:, 0].long()
    tv = torch.zeros((rows_all, N), dtype=torch.int64)
    tv[:batch] = tvs.long() & MASK
    for r in range(C):
        q = r * span + cols
        last = q // N == k1 - 1
        t = q % N
        am, flip = b0[:, None] & (N - 1), (b0[:, None] & N) != 0
        v = torch.gather(tv, 1, (t[None, :] - am) & (N - 1))
        neg = (t[None, :] < am) ^ flip
        v = torch.where(neg, (-v) & MASK, v)
        acc[r] = torch.where(last[None, :] & live[:, None], v, 0)
    for i in range(a_t.shape[0]):
        amt = torch.zeros(rows_all, dtype=torch.int64)
        amt[:batch] = a_t[i, :, 0].long()
        am, flip = amt & (N - 1), (amt & N) != 0
        dig = torch.zeros((rows_all, rows * N), dtype=torch.int64)
        written = torch.zeros(rows * N, dtype=torch.int64)
        for r in range(C):
            q0 = r * span + torch.arange(0, span, 8)        # items
            c, t0 = q0 // N, q0 % N
            frm = (t0[None, :] - am[:, None]) & (N - 1)    # [row, item]
            blk = frm & ~3
            words = []
            for h in range(3):
                src = c[None, :] * N + ((blk + 4 * h) & (N - 1))
                owner = src // span
                off = src - owner * span
                assert bool((off % 4 == 0).all())
                assert bool((off <= span - 4).all())
                words.append(acc[owner[..., None], g_idx,
                                 off[..., None] + torch.arange(4)])
            x = torch.cat(words, dim=-1)                    # [row, item, 12]
            j = torch.arange(8)
            v = torch.gather(x, 2, ((frm & 3)[..., None] + j).expand(
                -1, -1, 8))                                  # x[sh4 + j]
            t = t0[None, :, None] + j
            neg = (t < am[:, None, None]) ^ flip[:, None, None]
            rot = torch.where(neg, (-v) & MASK, v)
            own = acc[r].reshape(rows_all, span // 8, 8)
            w = ((((rot - own) & MASK) + (1 << (31 - bl))) & MASK) \
                >> (32 - bl)
            w = w + sum(half << (b * jj) for jj in range(l))
            for lev in range(l):
                dl = ((w >> (b * (l - 1 - lev))) & ((1 << b) - 1)) - half
                col = ((c[:, None] * l + lev) * N + N - 1 - t[0]).reshape(-1)
                dig[:, col] = (dl * live[:, None, None]).reshape(rows_all, -1)
                written.index_add_(0, col, torch.ones_like(col))
        assert bool((written == 1).all())
        news = []
        for r in range(C):
            q_lo = r * span
            q = q_lo + cols
            c_lo = q_lo // N
            nc = (q_lo + span - 1) // N - c_lo + 1
            bo = (((q >> log_n) - c_lo) * rows * 2 * N + (q & (N - 1))
                  + 4 * tig + 1)
            q_first = q_lo + 8 * tg * nt
            flat = (((tg + 1) * nt <= span // 8)
                    & ((q_first >> log_n) == ((q_first + 8 * nt - 1) >> log_n)))
            qf = q_first + gid
            bo0 = (((qf >> log_n) - c_lo) * rows * 2 * N + (qf & (N - 1))
                   + 4 * tig + 1)
            stage = torch.cat([torch.stack([
                keys[i, lb * k1 + c_lo + cc] for lb in range(L)
                for cc in range(nc)]).reshape(-1),
                torch.zeros(source_constant("kEPad"), dtype=torch.int8)])
            words = u32_words(stage)
            kc = torch.arange(chunks)
            ko = (kc // (N // 32) * 2 * N + kc % (N // 32) * 32
                  )[None, :, None, None]
            ko = ko + (torch.arange(L) * nc * rows * 2 * N)[:, None, None, None]
            bm = b_operand(words, ko + bo + 16 * hh,
                           ko + bo0 + 8 * (ntl + 2 * hh), flat).double()
            a = dig.reshape(rows_all, chunks, 32).double()
            d = torch.zeros((slices, L, rows_all, span), dtype=torch.float64)
            for ks in range(slices):
                lo, hi = ks * chunks // slices, (ks + 1) * chunks // slices
                d[ks] = torch.einsum("gck,lcks->lgs", a[:, lo:hi],
                                     bm[:, lo:hi])
            assert d.abs().max() < 2 ** 31
            add = sum((d[ks, lb].long() & MASK) << 8 * (lb + 4 - L)
                      for ks in range(slices) for lb in range(L)) & MASK
            news.append((acc[r] + add) & MASK * live[:, None])
        # every CTA's digits were read before any span changes (the cluster
        # barrier after the digits)
        acc = torch.stack(news)
    out = acc.permute(1, 0, 2).reshape(rows_all, kn)[:batch]
    out = ((out + (1 << 31)) & MASK) - (1 << 31)
    return out.reshape(batch, k1, N).permute(1, 0, 2)


# the JAX package's shapes and one more at each limb count, on the plan;
# then one pass a component, forced at bench --quick's shape and where the
# plan takes it (l = 5 at k = 12, N = 32: all digits and two key stages
# would take 227 KB); then one CTA a tile at the dry run's shape (four
# groups of 4 tiles, two contraction slices)
EMULATED = ([(name, limbs, None) for name in sorted(JAX_SHAPES)
             + ["k=2 N=32 l=2"] for limbs in (4, 3)]
            + [("bench --quick N=128", 4, "one pass a component"),
               ("k=12 N=32 l=5", 4, None),
               ("dryrun N=64", 3, "cluster 1")])


@pytest.mark.parametrize("name,limbs,variant", EMULATED)
def test_emulated_schedule_equals_plain(name, limbs, variant):
    params = SMALL_SHAPES.get(name) or shape(12, 32, 5, 6)
    k1 = params.glwe_dim + 1
    batch = 21  # ragged: a full tile of 16 and one of 5
    b_init, a_t, tvs, keys = operands(params, 3, batch, limbs, seed=limbs)
    plan = fbr.k1_small_plan(params, limbs)
    if name == "k=12 N=32 l=5":
        assert plan.passes == k1 and plan.cluster == 4
    elif variant == "one pass a component":
        assert plan.passes == 1
        plan = plan._replace(passes=k1)
    elif variant == "cluster 1":
        plan = fbr.k1_small_plan(params, limbs, cluster=1)
        assert (plan.nt, plan.passes) == (4, 1)
    else:
        assert plan.passes == 1
    assert -(-batch // plan.cb) == 2
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs, keys)))
    got = emulate_small(*args, params, plan)
    plain = fbr.blind_rotate_k1_plain(*args, params)
    assert torch.equal(got.to(torch.int32), plain)


# ------------------------------------------------ the runtime model's fit

def test_model_prices_the_small_kernel_with_its_own_fit(monkeypatch):
    """A small-N family without a calibration entry takes the ``k1s`` fit
    (fixed term and per-boot scale), not K1's ring-kernel fit; at N ≥ 256
    K1's fit stays; without a ``k1s`` fit the small kernel falls back to
    K1's (rel_tol 1e-12: the same floating-point sum)."""
    import copy
    cal = copy.deepcopy(calibration())
    cal["kernels"]["k1s"] = {"eff": 0.01, "fixed_us": 123.0, "scale": 7.0,
                             "families": ["x"]}
    monkeypatch.setattr(runtime_model, "calibration", lambda: cal)
    params = shape(1, 64, 2, 8)                  # no entry of its own
    assert runtime_model._entry(params, "fused_otf") is None
    plan, waves = runtime_model.launch_plan(params, 512, "fused_otf")
    assert isinstance(plan, fbr.K1SmallPlan)
    cost = runtime_model._cost(params, "fused_otf", 4)
    a, b = cal["around"]["around_a_us"], cal["around"]["around_b_us"]
    want = (123.0 + waves * plan.cb * cal["sms"] / plan.cluster * cost * 7.0
            + a + b * 512 * (params.big_dim + 1))
    got = runtime_model.launch_us(params, 512, "fused_otf")
    assert math.isclose(got, want, rel_tol=1e-12)
    assert math.isclose(runtime_model.slope_us(params, None, "fused_otf"),
                        cost * 7.0 + b * (params.big_dim + 1),
                        rel_tol=1e-12)
    ring = shape(1, 256, 2, 8)
    fit = cal["kernels"]["fused_otf"]
    assert runtime_model._kernel_fit(ring, "fused_otf")[:2] == (
        fit["fixed_us"], fit.get("scale", 1.0))
    del cal["kernels"]["k1s"]
    assert runtime_model._kernel_fit(params, "fused_otf")[:2] == (
        fit["fixed_us"], fit.get("scale", 1.0))


def test_bisect_variants_remove_one_phase_each():
    """The small-N bisect's source edits (``runtime/bisect.py --kernel
    k1s``) still find what they remove in the kernel's source, in both of
    its kernels (the small-N one and the small-tile one at N ≥ 256, which
    share the products): each variant differs from it, in its own way (the
    in-loop cluster barriers of ``local_only``, not the ones after the
    set-up), and the launches it times are the full-length ones of the
    paths that run the kernel, then the AES-128 family's."""
    from tfhe_fbs_map_tpu_torch.runtime import bisect
    var = bisect.k1s_variants(K1S_SOURCE)
    assert var["base"] == K1S_SOURCE
    mma = "mma_s8(d[rt][lb][nt]"
    assert K1S_SOURCE.count(mma) == 2
    assert mma not in var["no_products"] and mma not in var["loads_only"]
    for call in ("bulk_load(", "mbar_expect_tx(", "mbar_wait("):
        assert K1S_SOURCE.count(call) == 2 and call not in var["no_key_copy"]
    assert "= packed;" not in var["no_digits"]
    assert "store_to(at, peer" not in var["no_digits"]
    assert "ldmatrix_x4(a[rt]" not in var["mma_only"]
    assert "window(" not in var["mma_only"].split("products(")[1] \
        .split("\n}\n")[0]
    for name in ("no_exchange", "local_only"):
        assert "j < cluster; ++j" not in var[name]
    assert K1S_SOURCE.count("cluster_barrier();") == 5
    assert var["local_only"].count("cluster_barrier();") == 2
    assert "), owner)" not in var["local_only"]
    assert list(var) == ["base", "no_products", "no_key_copy", "no_digits",
                         "mma_only", "loads_only", "no_exchange",
                         "local_only"]
    assert len(set(var.values())) == len(var)
    launches = bisect.small_n_launches()
    assert [(p, b) for _, p, b in launches] == [
        (JAX_SHAPES["dryrun N=64"], 8),
        (JAX_SHAPES["bench --quick N=128"], 32),
        (JAX_SHAPES["staged fam2 N=128"], 40),
        (JAX_SHAPES["bench_multichip --quick N=128"], 16),
        (JAX_SHAPES["bench_multichip --quick N=128"], 48)]
    assert [(p, b) for _, p, b in bisect.wide_launches()] == [
        (PRESETS["aes128_p4"][0], 16), (PRESETS["aes128_p4"][0], 128)]


def calibration_shell(key: str) -> TFHEParams:
    """Params of a calibration key ``n,k,N,l,ks_l`` (plans read the sizes
    alone)."""
    n, k, N, l, ks_l = (int(x) for x in key.split(","))
    return TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=5, ksk_level=ks_l, ksk_base_log=2,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def test_calibration_has_the_small_kernels_point():
    """``calibration_h100.json`` holds the small-N kernel's own points
    (``calibrate --only k1s``): an entry for each of its families, timed
    through K1 (``fused_otf``), the kernel-wide ``k1s`` fit, and the plan
    and waves the card launched at every point, which are the model's; and
    every other entry is what the ring kernels' points alone fit to, so the
    small kernel's points were added without re-fitting them (rel_tol 1e-9:
    least squares on the same points, on another numpy build)."""
    import copy
    from tfhe_fbs_map_tpu_torch.optimizer import calibrate
    cal = calibration()
    small = calibrate.small_families()
    assert cal["kernels"]["k1s"]["families"] == sorted(small)
    for name, (params, _) in small.items():
        entry = cal["families"][runtime_model.entry_key(params, "fused_otf")]
        assert entry["name"] == name and entry["kernel"] == "fused_otf"
        assert runtime_model._kernel_fit(params, "fused_otf")[:2] == (
            entry["fixed_us"], entry["scale"])
    points = cal["raw"]["k1s_points"]
    assert {pt["family"] for pt in points} == set(small)
    for pt in points:
        plan, waves = runtime_model.launch_plan(
            calibration_shell(pt["key"]), pt["rows"], pt["kernel"],
            pt["limbs"])
        assert list(plan) == pt["plan"] and waves == pt["waves"]
    # the small-tile plan's points at N >= 256: every family of
    # calibrate.wide_families at every launch size on every tile and
    # cluster it is built for, the waves the model gives each; each
    # family's entry holds its fastest at each launch size, and the model
    # takes the plan of the least summed time over the families of a shape
    wide = cal["raw"]["k1s_wide_plans"]
    assert {pt["family"] for pt in wide} == set(calibrate.wide_families())
    for name, (params, _) in calibrate.wide_families().items():
        pts = [pt for pt in wide if pt["family"] == name]
        want = {(r, t, c) for r in runtime_model.SMALL_ROWS
                for t in fbr.K1S_WIDE_TILES
                for c in fbr.k1s_clusters(params, 4, t)}
        assert {(pt["rows"], *pt["plan"][:2]) for pt in pts} == want
        for pt in pts:
            plan = fbr.k1_wide_plan(pt["rows"], params, cal["sms"], 4,
                                    pt["plan"][1], cb=pt["plan"][0])
            assert list(plan) == pt["plan"]
            assert pt["waves"] == runtime_model._waves(
                pt["rows"], plan, lambda p: pt["resident"])
            assert pt["resident"] == cal["resident"][
                runtime_model.resident_key("fused_otf", 4, plan, params)]
        entry = cal["families"][runtime_model.entry_key(params, "k1s")]
        assert entry["name"] == name
        assert entry["points"] == [
            [r, min(pt["kernel_ms"] * 1e3 for pt in pts if pt["rows"] == r)]
            for r in runtime_model.SMALL_ROWS]
        # each tile and cluster by waves: its fullest launch of each count
        assert [p[:2] for p in entry["plans"]] == sorted(
            [list(t) for t in {tuple(pt["plan"][:2]) for pt in pts}])
        for t, c, resident, by_waves in entry["plans"]:
            mine = [pt for pt in pts if pt["plan"][:2] == [t, c]]
            assert {pt["resident"] for pt in mine} == {resident}
            assert by_waves == [
                [w, max((pt for pt in mine if pt["waves"] == w),
                        key=lambda pt: pt["rows"])["kernel_ms"] * 1e3]
                for w in sorted({pt["waves"] for pt in mine})]
        for r in runtime_model.SMALL_ROWS:
            same = [pt for pt in wide if pt["rows"] == r
                    and runtime_model.shape_key(calibration_shell(pt["key"]))
                    == runtime_model.shape_key(params)]
            sums = {}
            for pt in same:
                t = tuple(pt["plan"][:2])
                sums[t] = sums.get(t, 0.0) + pt["kernel_ms"] * 1e3
            assert runtime_model.small_tile_pick(params, r) == min(
                sums, key=sums.get)
    raw = copy.deepcopy(cal["raw"])
    del raw["k1s_points"]
    ring = calibrate.fit(raw)
    assert "k1s" not in ring["kernels"]
    for key, entry in ring["families"].items():
        for field, value in entry.items():
            got = cal["families"][key][field]
            if isinstance(value, str) or field in ("points", "plans"):
                assert got == value
            else:
                assert math.isclose(got, value, rel_tol=1e-9)
    for kern in ("fused", "fused_otf"):
        for field in ("eff", "fixed_us"):
            assert math.isclose(cal["kernels"][kern][field],
                                ring["kernels"][kern][field], rel_tol=1e-9)


# ----------------------------------------- the small-tile plan at N = 512

# the families K1's small-tile plan serves whose launches it takes
# (calibrate.wide_families): AES-128's, the bench anchor's and Kreyvium's
# fam2 (l = 4: one digit pass a component); two steps, so that the exchange
# of a step meets the next step's digits
WIDE = {"aes128_p4": PRESETS["aes128_p4"][0],
        "anchor": PRESETS["anchor"][0],
        "kreyvium fam2": STAGED_PRESETS["kreyvium_p10_staged"].fam2}
WIDE_BATCHES = (1, 4, 21, 64, 128, 256)


@pytest.mark.parametrize("name", sorted(WIDE))
@pytest.mark.parametrize("batch", WIDE_BATCHES)
@pytest.mark.parametrize("limbs", [4, 3])
def test_emulated_wide_schedule_equals_plain(name, batch, limbs):
    """K1's small-tile schedule at N = 512, on the plan the calibrated card
    takes at ``batch`` (its tile of 16 or 32, cluster and n8 tiles a warp),
    bitwise against the plain version."""
    params = dataclasses.replace(WIDE[name], lwe_dim=2)
    plan, _ = runtime_model.small_tile_plan(params, batch, limbs)
    assert plan.cb in fbr.K1S_WIDE_TILES and plan.passes == 1
    assert plan.cluster in fbr.k1s_clusters(params, limbs, plan.cb)
    b_init, a_t, tvs, keys = operands(params, 2, batch, limbs,
                                      seed=batch + limbs)
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs, keys)))
    got = emulate_wide(*args, params, plan)
    assert torch.equal(got.to(torch.int32),
                       fbr.blind_rotate_k1_plain(*args, params))


def test_route_takes_the_small_tile_plan_by_price(monkeypatch):
    """At N ≥ 256 the cost model sends a launch to the small-tile plan
    exactly where the family's own calibrated points (its ``.../k1s``
    entry) price its kernel below the ring kernel's plan at that launch
    size, and the runtime model then prices the launch from those points
    alone; the launch record names it ``k1s``; without such points or
    their fit across families the ring serves.  ``k1_plan`` runs the route
    it is handed, and without one the ring."""
    import copy
    cal = copy.deepcopy(calibration())
    aes = PRESETS["aes128_p4"][0]
    for key in [k for k in cal["families"] if k.endswith("/k1s")]:
        del cal["families"][key]
    del cal["kernels"]["k1s_wide"]
    monkeypatch.setattr(runtime_model, "calibration", lambda: cal)

    def chosen(rows):
        c = runtime_model.launch_choice(aes, rows, 1, "fused_otf")
        return c, fbr.k1_plan(rows, aes, 132, 4, *(c.tile or (None, None)),
                              route=c.route)

    for rows in (4, 64, 1024):
        assert not runtime_model.small_tile_wins(aes, rows)
        assert isinstance(chosen(rows)[1], fbr.K1Plan)
    # points at half the ring's kernel up to 64, twice it from 512: the
    # small tiles win where their points are the lower
    ring = {r: runtime_model.launch_us(aes, r, "fused_otf")
            - runtime_model._around(aes, "fused_otf")[0]
            - runtime_model._around(aes, "fused_otf")[1] * r
            * (aes.big_dim + 1) for r in runtime_model.SMALL_ROWS}
    cal = copy.deepcopy(cal)
    cal["families"][runtime_model.entry_key(aes, "k1s")] = {
        "name": "aes128_p4", "kernel": "k1s", "fixed_us": 0.0, "scale": 1.0,
        "around_a_us": 0.0, "around_b_us": 0.0,
        "points": [[r, us / 2 if r <= 64 else 2 * us]
                   for r, us in ring.items()]}
    for rows, small in ((4, True), (64, True), (1024, False)):
        assert runtime_model.small_tile_wins(aes, rows) is small
        c, plan = chosen(rows)
        assert isinstance(plan, fbr.K1SmallPlan) is small
        assert c.path == c.route == ("k1s" if small else "k1")
        got, waves = runtime_model.launch_plan(aes, rows, "fused_otf")
        assert got == fbr.k1_plan(
            rows, aes, cal["sms"], 4, *(c.tile or (None, None)),
            resident=lambda p: cal["resident"].get(
                runtime_model.resident_key("fused_otf", 4, p, aes),
                cal["sms"] // p.cluster), route=c.route)
        if small:
            a, b = runtime_model._around(aes, "fused_otf")
            want = ring[rows] / 2 + a + b * rows * (aes.big_dim + 1)
            assert math.isclose(runtime_model.launch_us(aes, rows,
                                                        "fused_otf"),
                                want, rel_tol=1e-12)
    # between points linear, past the last in proportion to the rows, at 3
    # limbs scaled by the per-boot cost
    pts = cal["families"][runtime_model.entry_key(aes, "k1s")]["points"]
    assert math.isclose(runtime_model.small_tile_us(aes, 96),
                        (pts[4][1] + pts[5][1]) / 2, rel_tol=1e-12)
    assert math.isclose(runtime_model.small_tile_us(aes, 4096),
                        2 * pts[-1][1], rel_tol=1e-12)
    assert math.isclose(runtime_model.small_tile_us(aes, 4, 3),
                        pts[0][1] * runtime_model._cost(aes, "fused_otf", 3)
                        / runtime_model._cost(aes, "fused_otf", 4),
                        rel_tol=1e-12)
    anchor = PRESETS["anchor"][0]
    assert not runtime_model.small_tile_wins(anchor, 4)
    assert isinstance(fbr.k1_plan(1024, aes, 132, route="k1s"),
                      fbr.K1SmallPlan)
    assert runtime_model.launch_choice(anchor, 4, 1, "fused_otf",
                                       route="k1s").path == "k1s"
    assert isinstance(fbr.k1_plan(4, aes, 132, route="k1"), fbr.K1Plan)
    assert isinstance(fbr.k1_plan(4, aes, 132), fbr.K1Plan)
    with pytest.raises(ValueError):
        fbr.k1_plan(4, aes, 132, route="k2")
    # without its limbs (2) or past its widths the ring serves alone
    assert runtime_model.k1_route(aes, 4, 2) == "k1"
    assert fbr.k1s_clusters(shape(1, 2048, 2, 8)) == []


def mapped_family(n: int, l: int, ks_l: int = 5) -> TFHEParams:
    """A k = 2, N = 512 family the calibration did not time (the mapped
    circuits' at their cheapest p: n 546 to 578, l 2 or 3)."""
    return dataclasses.replace(PRESETS["aes128_p4"][0], lwe_dim=n,
                               bsk_level=l, bsk_base_log=8, ksk_level=ks_l)


@pytest.mark.parametrize("n", [546, 560, 578])
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_family_without_points_takes_the_fit(n, l):
    """A family with no small-tile points of its own is priced by their fit
    across families: n times a step's µs at a shape the calibration timed,
    else n·step_us + scale·cost; it takes the plan where that price is
    below the ring's model, and the runtime model prices its launches so."""
    cal = calibration()
    fit = cal["kernels"]["k1s_wide"]
    params = mapped_family(n, l)
    assert runtime_model.entry_key(params, "k1s") not in cal["families"]
    shape = fit["shapes"].get(runtime_model.shape_key(params))
    if shape is not None:
        want = [[r, n * s] for r, s in zip(fit["rows"], shape)]
    else:
        cost = runtime_model._cost(params, "fused_otf", 4)
        want = [[r, n * a + b * cost]
                for r, a, b in zip(fit["rows"], fit["step_us"], fit["scale"])]
    assert runtime_model.small_points(params) == want
    taken = set()
    for rows in runtime_model.SMALL_ROWS:
        for limbs in (4, 3):
            small = runtime_model.small_tile_us(params, rows, limbs)
            ring, waves = runtime_model.launch_plan(params, rows,
                                                    "fused_otf", limbs, "k1")
            ring_us = runtime_model._kernel_term(
                params, ring, waves,
                runtime_model._cost(params, "fused_otf", limbs),
                runtime_model._kernel_fit(params, "fused_otf"))
            wins = runtime_model.small_tile_wins(params, rows, limbs)
            assert wins == (small < ring_us)
            assert runtime_model.k1_route(params, rows, limbs) == (
                "k1s" if wins else "k1")
            taken.add(wins)
            if wins:
                a, b = runtime_model._around(params, "fused_otf")
                assert runtime_model.launch_us(
                    params, rows, "fused_otf", limbs) == \
                    small + a + b * rows * (params.big_dim + 1)
    assert taken == {True, False}


def test_the_fit_holds_at_the_rings_timed_alone():
    """Families of a (k, N) the calibration did not time the small-tile
    plan at (here N = 256, and k = 1 at N = 512), or that it does not serve
    at both limbs, have no price of it and keep the ring."""
    for params in (shape(2, 256, 2, 8), dataclasses.replace(
            PRESETS["aes128_p4"][0], glwe_dim=1),
            mapped_family(560, 5, 5)):
        assert runtime_model.small_points(params) is None
        assert not any(runtime_model.small_tile_wins(params, r)
                       for r in runtime_model.SMALL_ROWS)


def test_calibrated_family_is_set_point_against_point(monkeypatch):
    """Where the calibration has both routes' points at a launch size, the
    route compares them; elsewhere the small-tile point meets the ring's
    model.  A small-tile point between the ring's point (below) and its
    model (above) keeps the ring where the ring was timed and takes the
    small tiles where it was not."""
    import copy
    cal = copy.deepcopy(calibration())
    aes = PRESETS["aes128_p4"][0]
    ring_entry = cal["families"][runtime_model.entry_key(aes, "fused_otf")]
    timed = dict(ring_entry["points"])
    monkeypatch.setattr(runtime_model, "calibration", lambda: cal)
    model = {}
    for r in runtime_model.SMALL_ROWS:
        ring, waves = runtime_model.launch_plan(aes, r, "fused_otf", 4, "k1")
        model[r] = runtime_model._kernel_term(
            aes, ring, waves, runtime_model._cost(aes, "fused_otf", 4),
            runtime_model._kernel_fit(aes, "fused_otf"))
    # the ring's points 10% below its model; the small tiles' 5% below it
    ring_entry["points"] = [[r, 0.9 * model[r]] for r in timed
                            if r in model]
    cal["families"][runtime_model.entry_key(aes, "k1s")]["points"] = [
        [r, 0.95 * model[r]] for r in runtime_model.SMALL_ROWS]
    for r in runtime_model.SMALL_ROWS:
        assert runtime_model.small_tile_wins(aes, r) == (r not in timed)
    assert {r for r in runtime_model.SMALL_ROWS if r in timed} \
        and {r for r in runtime_model.SMALL_ROWS if r not in timed}


def test_small_tile_plan_is_the_one_timed_fastest(monkeypatch):
    """The cost model's small-tile plan at a shape the calibration timed is
    the one it prices lowest by waves at the launch, summed over the
    shape's families (each plan's time at the launch's waves where timed,
    linear in the waves between two timed, in proportion past the most),
    where that plan serves the limbs: at AES-128's shape 16 on 16 CTAs up
    to 7 tiles of 16 (one wave), 16 on 8 for 8 to 15; the launch choice
    hands that tile and cluster to the kernel.  Elsewhere, and in the
    kernel given none, the fewest waves, then the smaller tile, then the
    most CTAs a tile."""
    import copy
    cal = copy.deepcopy(calibration())
    monkeypatch.setattr(runtime_model, "calibration", lambda: cal)
    aes = PRESETS["aes128_p4"][0]
    shape = runtime_model.shape_key(aes)
    fams = [e["plans"] for key, e in cal["families"].items()
            if e["kernel"] == "k1s" and runtime_model.shape_key(
                calibration_shell(key.split("/")[0])) == shape]
    assert len(fams) == 3

    def price(plans, tile, cluster, rows):
        (resident, by), = [(r, dict(w)) for t, c, r, w in plans
                           if (t, c) == (tile, cluster)]
        waves = -(-(-(-rows // tile)) // resident)
        timed = sorted(by)
        if waves in by:
            return by[waves]
        if waves > timed[-1]:
            return by[timed[-1]] * waves / timed[-1]
        lo = max(w for w in timed if w < waves)
        hi = min(w for w in timed if w > waves)
        return by[lo] + (by[hi] - by[lo]) * (waves - lo) / (hi - lo)

    tiles = {(t, c) for t, c, *_ in fams[0]}
    for rows in (1, 4, 21, 64, 100, 112, 113, 128, 200, 240, 241, 256, 384,
                 448, 512, 3000, 4096):
        want = min(tiles, key=lambda tc: (sum(
            price(p, *tc, rows) for p in fams), tc[0], -tc[1]))
        assert runtime_model.small_tile_pick(aes, rows) == want, rows
        plan, _ = runtime_model.small_tile_plan(aes, rows)
        assert (plan.cb, plan.cluster) == want
        assert runtime_model.launch_choice(aes, rows, 1, "fused_otf",
                                           route="k1s").tile == want
    assert {runtime_model.small_tile_pick(aes, r)
            for r in range(1, 113)} == {(16, 16)}
    assert {runtime_model.small_tile_pick(aes, r)
            for r in range(113, 241)} == {(16, 8)}
    # a pick the limbs do not serve, and a shape not timed: the rule
    for e in cal["families"].values():
        if e.get("plans") in fams:
            e["plans"] = [[32, 5, 1, [[1, 1.0]]]]
    runtime_model._WAVES.clear()
    runtime_model._PICKS.clear()
    assert runtime_model.small_tile_pick(aes, 64) == (32, 5)
    assert runtime_model.launch_choice(aes, 64, 1, "fused_otf",
                                       route="k1s").tile is None

    def rule(rows, params, resident):
        best = None
        for t in fbr.K1S_WIDE_TILES:
            for c in fbr.k1s_clusters(params, 4, t):
                plan = fbr.k1_wide_plan(rows, params, 132, 4, c, cb=t)
                waves = -(-(-(-rows // t)) // resident(plan))
                key = (waves, t, -c)
                if best is None or key < best[0]:
                    best = (key, plan)
        return best[1]

    for params in (aes, mapped_family(560, 3)):
        for rows in (4, 64, 128, 256, 512):
            assert fbr.k1_wide_plan(rows, params, 132) == rule(
                rows, params, lambda p: 132 // p.cluster)
            assert fbr.k1_wide_plan(rows, params, 132,
                                    resident=lambda p: 7) == rule(
                rows, params, lambda p: 7)
