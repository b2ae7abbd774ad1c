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
    edges = np.array([0, N - 1, N, 2 * N - 1], dtype=np.int32)
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
    """Every preset has N ≥ 256: K1 serves it with its ring kernel, whose
    plan is unchanged; the small-N kernel takes none of them."""
    params = PRESETS[name][0]
    assert params.poly_size >= fbr.K1_SLICE
    assert fbr.unsupported(params, otf=True) is None
    plan = fbr.k1_plan(batch, params, 132)
    assert plan.cb in fbr.K1_TILES and plan.nw in fbr.K1_WIDTHS


SMALL_SHAPES = {**JAX_SHAPES, **{
    f"k={k} N={N} l={l}": shape(k, N, l, base_log(l))
    for k in (1, 2) for N in SMALL_N for l in (2, 3)}}


def owners(plan, kn, chunks):
    """(column, contraction chunk) -> (CTA, warp) of every product the
    plan's CTAs and warps compute: CTA r the span [r·span, (r+1)·span),
    its warps groups of nt n8 tiles, as many as cover them rounded up to a
    power of two, warp w group w % groups over slice w // groups of the
    ``chunks`` 32-byte chunks."""
    span = kn // plan.cluster
    tiles = span // 8
    groups = fbr.k1s_groups(span, plan.nt)
    assert groups >= -(-tiles // plan.nt) and fbr.K1S_WARPS % groups == 0
    slices = fbr.K1S_WARPS // groups
    held = {}
    for r in range(plan.cluster):
        for w in range(fbr.K1S_WARPS):
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

def emulate_small(b_init, a_t, tvs, keys, params, plan):
    """The small-N K1's CUDA schedule in plain torch; keys
    [n, L·(k+1), rows, 2N].  Every CTA of a tile's cluster keeps its own
    copy of the tile's ACC, double-buffered; a step's CTA computes its
    digits from its copy of buffer i&1 (all k+1 components in one pass, or
    one pass a component, as the plan says), its span's products from the
    key stage it copied, one int32 fragment sum a contraction slice (its
    warps' share of every pass's chunks), the slices' limb-shifted sums
    added mod 2^32, and stores its span of the new ACC into buffer (i+1)&1
    of every copy."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    L = keys.shape[1] // k1
    batch, cb, C = tvs.shape[0], plan.cb, plan.cluster
    kn, rows = k1 * N, k1 * l
    span, passes = kn // C, plan.passes
    cpp, prow = k1 // passes, rows // passes
    bl, half = b * l, 1 << (b - 1)

    # every (column, chunk) product on exactly one (CTA, warp)
    chunks = prow * N // 32
    assert len(owners(plan, kn, chunks)) == kn * chunks
    slices = fbr.K1S_WARPS // fbr.k1s_groups(span, plan.nt)
    slice_of = [ks for kc in range(chunks) for ks in range(slices)
                if ks * chunks // slices <= kc < (ks + 1) * chunks // slices]
    # a B fragment's bytes: column (comp, t), contraction k of a 32-wide
    # chunk at j0 reads E[t + j0 + k + 1]; as two aligned words a window it
    # reads at most 4 bytes past the row, inside the next row or kEPad
    top = (N - 1) + (N - 32) + 31 + 1
    assert (top & ~3) + 7 < 2 * N + source_constant("kEPad")
    kk = torch.arange(32)[:, None]

    def rotated(rows_, amt):
        """X^amt · rows, [cb, N] uint32 values in int64."""
        am = amt & (N - 1)
        src = (torch.arange(N)[None, :] - am[:, None]) & (N - 1)
        v = torch.gather(rows_, 1, src)
        neg = (torch.arange(N)[None, :] < am[:, None]) \
            ^ ((amt & N) != 0)[:, None]
        return torch.where(neg, (-v) & MASK, v)

    out = torch.zeros((batch, kn), dtype=torch.int64)
    for tile in range(-(-batch // cb)):
        g = torch.arange(tile * cb, min((tile + 1) * cb, batch))
        live = len(g)
        # copies [CTA][buffer][cb][(comp, t)]
        acc = torch.zeros((C, 2, cb, kn), dtype=torch.int64)
        acc[:, 0, :live, (k1 - 1) * N:] = rotated(tvs[g].long() & MASK,
                                                  b_init[g, 0].long())
        for i in range(a_t.shape[0]):
            cur, nxt = i & 1, (i + 1) & 1
            amt = torch.zeros(cb, dtype=torch.int64)
            amt[:live] = a_t[i, g, 0].long()
            spans = []
            for r in range(C):
                q = torch.arange(r * span, (r + 1) * span)
                c_lo = r * span // N
                nc = ((r + 1) * span - 1) // N - c_lo + 1
                co, t = q // N - c_lo, q % N
                d = torch.zeros((slices, L, cb, span), dtype=torch.float64)
                for p in range(passes):
                    dig = torch.zeros((cb, prow * N), dtype=torch.int64)
                    for ci in range(cpp):
                        own = acc[r, cur, :, (p * cpp + ci) * N:][:, :N]
                        diff = (rotated(own, amt) - own) & MASK
                        w = ((diff + (1 << (31 - bl))) & MASK) >> (32 - bl)
                        w = w + sum(half << (b * j) for j in range(l))
                        for lev in range(l):
                            dl = ((w >> (b * (l - 1 - lev)))
                                  & ((1 << b) - 1)) - half
                            dig[:live, (ci * l + lev) * N + N - 1
                                - torch.arange(N)] = dl[:live]
                    # the stage as the bulk copies lay it: [L][nc][prow][2N]
                    stage = torch.stack([
                        keys[i, lb * k1 + c_lo + c, p * prow:(p + 1) * prow]
                        for lb in range(L) for c in range(nc)]).long() \
                        .reshape(L, nc, prow, 2 * N)
                    for kc in range(chunks):
                        rr, j0 = kc // (N // 32), kc % (N // 32) * 32
                        a = dig[:, 32 * kc:32 * kc + 32].double()
                        idx = t[None, :] + j0 + kk + 1         # [32, span]
                        for lb in range(L):
                            bm = stage[lb, co[None, :], rr, idx]
                            d[slice_of[kc], lb] += a @ bm.double()
                    # int32 fragment sums: exact and in range
                    assert d.abs().max() < 2 ** 31
                add = sum((d[ks, lb].long() & MASK) << 8 * (lb + 4 - L)
                          for ks in range(slices)
                          for lb in range(L)) & MASK          # [cb, span]
                spans.append((acc[r, cur][:, q] + add) & MASK)
            for r, new in enumerate(spans):
                acc[:, nxt, :, r * span:(r + 1) * span] = new
        fin = a_t.shape[0] & 1
        assert all(torch.equal(acc[r, fin], acc[0, fin]) for r in range(C))
        out[g] = acc[0, fin, :live]
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
    assert runtime_model._kernel_fit(ring, "fused_otf") == (
        fit["fixed_us"], fit.get("scale", 1.0))
    del cal["kernels"]["k1s"]
    assert runtime_model._kernel_fit(params, "fused_otf") == (
        fit["fixed_us"], fit.get("scale", 1.0))


def test_bisect_variants_remove_one_phase_each():
    """The small-N bisect's source edits (``runtime/bisect.py --kernel
    k1s``) still find what they remove in the kernel's source: each variant
    differs from it, in its own way (the in-loop cluster barrier of
    ``local_only``, not the one after the set-up), and the launches it
    times are the full-length ones of the paths that run the kernel."""
    from tfhe_fbs_map_tpu_torch.runtime import bisect
    var = bisect.k1s_variants(K1S_SOURCE)
    assert var["base"] == K1S_SOURCE
    assert K1S_SOURCE.count("mma_s8(d[lb][nt]") == 1
    assert "mma_s8(d[lb][nt]" not in var["no_products"]
    for call in ("bulk_load(", "mbar_expect_tx(", "mbar_wait("):
        assert K1S_SOURCE.count(call) == 1 and call not in var["no_key_copy"]
    assert "= packed;" not in var["no_digits"]
    assert "ldmatrix_x4(a," not in var["mma_only"]
    assert "window(er" not in var["mma_only"]
    assert "mma_s8(d[lb][nt]" not in var["loads_only"]
    for name in ("no_exchange", "local_only"):
        assert "j < cluster; ++j" not in var[name]
    assert K1S_SOURCE.count("cluster_barrier();") == 2
    assert var["local_only"].count("cluster_barrier();") == 1
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
        assert runtime_model._kernel_fit(params, "fused_otf") == (
            entry["fixed_us"], entry["scale"])
    points = cal["raw"]["k1s_points"]
    assert {pt["family"] for pt in points} == set(small)
    for pt in points:
        plan, waves = runtime_model.launch_plan(
            calibration_shell(pt["key"]), pt["rows"], pt["kernel"],
            pt["limbs"])
        assert list(plan) == pt["plan"] and waves == pt["waves"]
    raw = copy.deepcopy(cal["raw"])
    del raw["k1s_points"]
    ring = calibrate.fit(raw)
    assert "k1s" not in ring["kernels"]
    for key, entry in ring["families"].items():
        for field, value in entry.items():
            got = cal["families"][key][field]
            assert got == value if isinstance(value, str) \
                else math.isclose(got, value, rel_tol=1e-9)
    for kern in ("fused", "fused_otf"):
        for field in ("eff", "fixed_us"):
            assert math.isclose(cal["kernels"][kern][field],
                                ring["kernels"][kern][field], rel_tol=1e-9)
