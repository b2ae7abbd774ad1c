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


@pytest.mark.parametrize("name", sorted(SMALL_SHAPES))
@pytest.mark.parametrize("batch", BATCHES)
def test_small_plan_covers_the_columns(name, batch):
    """K1's plan below N=256 is the small-N kernel's one plan, whatever the
    limbs and the batch: tiles of 16, the fewest n8 tiles a warp that cover
    the (k+1)·N columns."""
    params = SMALL_SHAPES[name]
    assert fbr.unsupported(params, otf=True) is None
    k1, N = params.glwe_dim + 1, params.poly_size
    for limbs in (4, 3, 1):
        plan = fbr.k1_plan(batch, params, 132, limbs)
        assert plan == fbr.k1_small_plan(params)
        assert plan.cb == fbr.K1S_TILE == 16 and plan.cluster == 1
        assert plan.nt in fbr.K1S_TILES_A_WARP
        assert plan.nt * fbr.K1S_WARPS * 8 >= k1 * N
        smaller = [t for t in fbr.K1S_TILES_A_WARP if t < plan.nt]
        assert all(t * fbr.K1S_WARPS * 8 < k1 * N for t in smaller)
        tiles = -(-batch // plan.cb)
        assert 0 < batch - (tiles - 1) * 16 <= 16


@pytest.mark.parametrize("name", sorted(JAX_SHAPES))
@pytest.mark.parametrize("rows", BATCHES)
def test_model_prices_the_small_plan(name, rows):
    """The runtime model prices a small-N K1 call at the plan the card
    launches (``_launch_k1`` takes ``k1_device_plan``'s, which is
    ``k1_plan``'s): tiles of 16, one CTA a tile, and waves of as many CTAs
    as the calibrated card runs at once (one an SM where the resident
    table has no entry)."""
    params = JAX_SHAPES[name]
    cal = calibration()
    plan, waves = runtime_model.launch_plan(params, rows, "fused_otf")
    assert isinstance(plan, fbr.K1SmallPlan)
    assert plan == fbr.k1_plan(rows, params, cal["sms"])
    resident = cal["resident"].get(
        runtime_model.resident_key("fused_otf", 4, plan), cal["sms"])
    assert waves == -(-(-(-rows // 16)) // resident)
    assert runtime_model.launch_us(params, rows, "fused_otf") > 0


def test_small_plan_at_the_largest_rows_fits_shared_memory():
    """b = 1 allows l = 31 (b·l < 32): the widest served small shapes, at
    every N and the most columns, still fit a CTA's shared memory, as the
    kernel's source lays it out (ACC [k+1][16][N + kAccPad] uint32, the
    digits [16][l·N + kDigPad] int8, the E rows [L][k+1][l][2N] int8 and
    kEPad bytes); ``tests/test_torch_gpu.py`` asks the built kernel."""
    cb = source_constant("kCB")
    acc, dig, e = (source_constant(c) for c in ("kAccPad", "kDigPad",
                                                "kEPad"))
    assert cb == fbr.K1S_TILE
    for N in SMALL_N:
        k = fbr.K1S_MAX_KN // N - 1
        params = shape(k, N, 31, 1)
        assert fbr.unsupported(params, otf=True) is None
        smem = (4 * (k + 1) * cb * (N + acc) + cb * (31 * N + dig)
                + fbr.N_LIMBS * (k + 1) * 31 * 2 * N + e)
        assert smem <= fbr.SMEM_MAX


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
    """Tiles, clusters and widths are the N ≥ 256 kernel's knobs; the plan
    that the small-N kernel launches with refuses them before the card is
    touched."""
    params = JAX_SHAPES["dryrun N=64"]
    with pytest.raises(ValueError, match="no cluster"):
        fbr.k1_plan(64, params, 132, cb=64)
    with pytest.raises(ValueError, match="no cluster"):
        fbr.k1_plan(64, params, 132, cluster=2)
    with pytest.raises(ValueError, match="no nw"):
        fbr.k1_plan(64, params, 132, nw=32)
    assert fbr.k1_plan(64, params, 132, cb=16, cluster=1) \
        == fbr.k1_small_plan(params)


# ------------------------------------------------ emulation of the kernel

def emulate_small(b_init, a_t, tvs, keys, params, plan):
    """The small-N K1's CUDA schedule in plain torch; keys
    [n, L·(k+1), rows, 2N]."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    L = keys.shape[1] // k1
    batch, cb = tvs.shape[0], plan.cb
    kn = k1 * N
    bl, half = b * l, 1 << (b - 1)

    # warp w holds the n8 tiles w, w + 8, ...: each tile exactly once
    held = [w + fbr.K1S_WARPS * s for w in range(fbr.K1S_WARPS)
            for s in range(plan.nt) if w + fbr.K1S_WARPS * s < kn // 8]
    assert sorted(held) == list(range(kn // 8))

    # a B fragment's bytes: column q = (comp, t), contraction k of a 32-wide
    # chunk at j0 reads E[t + j0 + k + 1]; as two aligned words a window it
    # reads at most 3 bytes past the row, inside the E padding
    q = torch.arange(kn)
    comp, t = q // N, q % N
    kk = torch.arange(32)[:, None]
    top = (N - 1) + (N - 32) + 31 + 1
    assert (top & ~3) + 3 < 2 * N + source_constant("kEPad")

    def rotated(rows, amt):
        """X^amt · rows, [cb, N] uint32 values in int64."""
        am = amt & (N - 1)
        src = (torch.arange(N)[None, :] - am[:, None]) & (N - 1)
        v = torch.gather(rows, 1, src)
        neg = (torch.arange(N)[None, :] < am[:, None]) \
            ^ ((amt & N) != 0)[:, None]
        return torch.where(neg, (-v) & MASK, v)

    out = torch.zeros((k1, batch, N), dtype=torch.int64)
    for tile in range(-(-batch // cb)):
        g = torch.arange(tile * cb, min((tile + 1) * cb, batch))
        live = len(g)
        acc = torch.zeros((k1, cb, N), dtype=torch.int64)
        acc[k1 - 1, :live] = rotated(tvs[g].long() & MASK,
                                     b_init[g, 0].long())
        for i in range(a_t.shape[0]):
            amt = torch.zeros(cb, dtype=torch.int64)
            amt[:live] = a_t[i, g, 0].long()
            d = torch.zeros((L, cb, kn), dtype=torch.float64)
            for ci in range(k1):
                diff = (rotated(acc[ci], amt) - acc[ci]) & MASK
                w = ((diff + (1 << (31 - bl))) & MASK) >> (32 - bl)
                w = w + sum(half << (b * j) for j in range(l))
                dig = torch.zeros((cb, l * N), dtype=torch.int64)
                for lev in range(l):
                    dl = ((w >> (b * (l - 1 - lev))) & ((1 << b) - 1)) - half
                    dig[:live, lev * N + N - 1 - torch.arange(N)] = dl[:live]
                es = keys[i, :, ci * l:(ci + 1) * l].long()  # [L·k1, l, 2N]
                for lev in range(l):
                    for j0 in range(0, N, 32):
                        a = dig[:, lev * N + j0:lev * N + j0 + 32].double()
                        idx = t[None, :] + j0 + kk + 1         # [32, kN]
                        for lb in range(L):
                            bm = es[lb * k1 + comp[None, :], lev, idx]
                            d[lb] += a @ bm.double()
                # int32 fragment sums: exact and in range
                assert d.abs().max() < 2 ** 31
            add = sum((d[lb].long() & MASK) << 8 * (lb + 4 - L)
                      for lb in range(L)) & MASK             # [cb, kN]
            acc = (acc + add.reshape(cb, k1, N).permute(1, 0, 2)) & MASK
        out[:, g] = acc[:, :live]
    return ((out + (1 << 31)) & MASK) - (1 << 31)


@pytest.mark.parametrize("name", sorted(JAX_SHAPES) + ["k=2 N=32 l=2"])
@pytest.mark.parametrize("limbs", [4, 3])
def test_emulated_schedule_equals_plain(name, limbs):
    params = SMALL_SHAPES[name]
    batch = 21  # ragged: a full tile of 16 and one of 5
    b_init, a_t, tvs, keys = operands(params, 3, batch, limbs, seed=limbs)
    plan = fbr.k1_small_plan(params)
    assert -(-batch // plan.cb) == 2
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs, keys)))
    got = emulate_small(*args, params, plan)
    plain = fbr.blind_rotate_k1_plain(*args, params)
    assert torch.equal(got.to(torch.int32), plain)
