"""K2's launch plan and a plain emulation of its CUDA schedule.

``k2_plan`` is checked at every preset and batch size of the main path.  The
emulation runs the kernel's schedule in plain torch: clusters of CTAs that
each own a slice of the (k+1)·N output coefficients, compute the digits of
their own coefficients into a shared scratch, sum int32 partial products
over 128-byte contraction chunks and combine the limbs of their slice.  It is
held bitwise against ``blind_rotate_k2_plain`` and the JAX ``_kernel`` in
interpret mode, including limb drop and a ragged last tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, TFHEParams

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

SMS = 132
MASK = (1 << 32) - 1
BATCHES = (1, 21, 64, 512, 1024, 2048)


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("batch", BATCHES)
def test_plan_fits_the_card(preset, batch):
    params = PRESETS[preset][0]
    assert fbr.unsupported(params, otf=False) is None
    kn = (params.glwe_dim + 1) * params.poly_size
    for limbs in (4, 3, 1):
        plan = fbr.k2_plan(batch, params, SMS, limbs)
        assert plan.cb in fbr.K2_TILES and plan.chunk == fbr.K2_CHUNK
        assert 1 <= plan.cluster <= fbr.K2_MAX_CLUSTER
        # each CTA's slice is a whole number of column chunks
        assert kn % (plan.cluster * plan.chunk) == 0
        assert 2 <= plan.stages <= fbr.K2_MAX_STAGES
        rows = max(plan.cb, fbr.K2_ROWS) + limbs * plan.chunk
        assert plan.smem == plan.stages * rows * fbr.K2_KC \
            + fbr.K2_SMEM_EXTRA <= fbr.SMEM_MAX
        tiles = -(-batch // plan.cb)
        # the ragged last tile holds 1..cb ciphertexts
        assert 0 < batch - (tiles - 1) * plan.cb <= plan.cb
        # one wave of CTAs, one an SM
        assert tiles * plan.cluster <= SMS
    # the main path's level: 64- or 128-ciphertext tiles fill the card
    if batch == 1024:
        plan = fbr.k2_plan(batch, params, SMS)
        tiles = -(-batch // plan.cb)
        assert plan.cb >= 64 and 96 <= tiles * plan.cluster <= SMS


def test_plan_keeps_one_wave_of_resident_clusters():
    """Clusters the H100 runs at once with one CTA an SM, by cluster size
    (cudaOccupancyMaxActiveClusters on an H100 80GB HBM3): 16 tiles of 64
    would take two waves of clusters of 8, 8 tiles of 128 two waves of
    clusters of 12; 8 tiles of 128 in clusters of 8 fit one wave."""
    h100 = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15, 12: 7, 16: 7}
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k2_plan(1024, params, SMS, resident=lambda p: h100[p.cluster])
    assert (plan.cb, plan.cluster) == (128, 8)
    plan = fbr.k2_plan(2048, params, SMS, resident=lambda p: h100[p.cluster])
    assert (plan.cb, plan.cluster) == (128, 6)
    for batch in BATCHES:
        plan = fbr.k2_plan(batch, params, SMS,
                           resident=lambda p: h100[p.cluster])
        assert -(-batch // plan.cb) <= h100[plan.cluster]


def test_plan_overrides_and_refusals():
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k2_plan(1024, params, SMS, cb=16, cluster=3)
    assert (plan.cb, plan.cluster) == (16, 3)
    assert fbr.k2_clusters(params) == [12, 8, 6, 4, 3, 2, 1]
    assert fbr.k2_clusters(PRESETS["test"][0]) == [8, 4, 2, 1]
    assert fbr.k2_clusters(PRESETS["p16"][0]) == [16, 8, 4, 2, 1]
    bad = TFHEParams(**{**vars(params), "poly_size": 32, "bsk_level": 1})
    assert "multiple of 128" in fbr.unsupported(bad, otf=False)
    # K1 serves it, through its kernel for N below K1_SLICE
    assert bad.poly_size < fbr.K1_SLICE
    assert fbr.unsupported(bad, otf=True) is None
    # N = 16 and a non-power of two: neither kernel
    for n, why in ((16, "multiple of 32"), (96, "power of two")):
        odd = TFHEParams(**{**vars(bad), "poly_size": n})
        for otf in (False, True):
            assert why in fbr.unsupported(odd, otf=otf)


# ------------------------------------------------ emulation of the kernel

def emulate_k2(b_init, a_t, tvs, keys, params, plan):
    """K2's CUDA schedule in plain torch; keys [n, L·(k+1)·N, rows·N]."""
    k1, N = params.glwe_dim + 1, params.poly_size
    l, b = params.bsk_level, params.bsk_base_log
    K, kn = k1 * l * N, k1 * N
    L = keys.shape[1] // kn
    batch = tvs.shape[0]
    cb, C, W = plan.cb, plan.cluster, plan.chunk
    tiles, span, nk = -(-batch // cb), kn // C, K // fbr.K2_KC
    rows = torch.arange(batch)

    def rotated(vals, q, amt):
        """Coefficients q of X^amt·vals[c(q)], vals [k+1, B, N] uint32."""
        c, t = q // N, q % N
        am = amt & (N - 1)
        src = (t[None, :] - am[:, None]) & (N - 1)
        v = vals[c[None, :], rows[:, None], src]
        neg = (t[None, :] < am[:, None]) ^ ((amt & N) != 0)[:, None]
        return torch.where(neg, (-v) & MASK, v)

    acc = torch.zeros((k1, batch, N), dtype=torch.int64)
    last = torch.arange((k1 - 1) * N, kn)
    src = torch.zeros_like(acc)
    src[k1 - 1] = tvs.long() & MASK
    acc[k1 - 1] = rotated(src, last, b_init[:, 0].long())

    bl, half = b * l, 1 << (b - 1)
    for i in range(a_t.shape[0]):
        amt = a_t[i, :, 0].long()
        dig = torch.zeros((tiles * cb, K), dtype=torch.int64)
        for r in range(C):  # each CTA: digits of its own coefficients
            q = torch.arange(r * span, (r + 1) * span)
            c, t = q // N, q % N
            diff = (rotated(acc, q, amt) - acc[c[None, :], rows[:, None],
                                               t[None, :]]) & MASK
            w = ((diff + (1 << (31 - bl))) & MASK) >> (32 - bl)
            w = w + sum(half << (b * j) for j in range(l))
            for lev in range(l):
                d = ((w >> (b * (l - 1 - lev))) & ((1 << b) - 1)) - half
                dig[:batch, (c * l + lev) * N + t] = d
        key = keys[i].double()
        for tile in range(tiles):
            a = dig[tile * cb:(tile + 1) * cb].double()
            g = torch.arange(tile * cb, min((tile + 1) * cb, batch))
            for r in range(C):
                for ch in range(span // W):
                    q0 = r * span + ch * W
                    cols = torch.cat([lb * kn + q0 + torch.arange(W)
                                      for lb in range(L)])
                    bm = key[cols]
                    # int32 partial sums over 128-byte contraction chunks
                    part = torch.bmm(
                        a.reshape(cb, nk, -1).permute(1, 0, 2),
                        bm.reshape(len(cols), nk, -1).permute(1, 2, 0))
                    run = part.cumsum(0)
                    assert run.abs().max() < 2 ** 31
                    p = run[-1].long()[:len(g)] & MASK
                    add = sum((p[:, lb * W:(lb + 1) * W]
                               << 8 * (lb + 4 - L)) & MASK
                              for lb in range(L))
                    q = q0 + torch.arange(W)
                    c, t = q // N, q % N
                    cur = acc[c[None, :], g[:, None], t[None, :]]
                    acc[c[None, :], g[:, None], t[None, :]] = (cur + add) & MASK
    return ((acc + (1 << 31)) & MASK) - (1 << 31)


def k2_operands(params, steps, batch, limbs, seed):
    rng = np.random.default_rng(seed)
    k1, N = params.glwe_dim + 1, params.poly_size
    K = k1 * params.bsk_level * N
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (steps, batch, 1)).astype(np.int32)
    edges = np.array([0, N - 1, N, 2 * N - 1], dtype=np.int32)
    a_t[:, :4, 0] = edges
    b_init[:4, 0] = edges
    tvs = rng.integers(-2 ** 31, 2 ** 31, (batch, N)).astype(np.int32)
    keys = rng.integers(-128, 128, (steps, limbs * k1 * N, K), dtype=np.int8)
    return b_init, a_t, tvs, keys


AES = PRESETS["aes128_p4"][0]
CASES = {  # label -> (params, steps)
    "test": (PRESETS["test"][0], PRESETS["test"][0].lwe_dim),
    "aes128_p4 n=8": (AES, 8),
}


@pytest.mark.parametrize("label", sorted(CASES))
@pytest.mark.parametrize("limbs", [4, 3])
@pytest.mark.parametrize("plan_of", ["default", "cb=32"])
def test_emulated_schedule_equals_plain_and_jax(label, limbs, plan_of):
    params, steps = CASES[label]
    batch = 21  # ragged: 21 = 16 + 5 at cb=16, one short tile at cb=32
    b_init, a_t, tvs, keys = k2_operands(params, steps, batch, limbs,
                                         seed=limbs)
    cb = None if plan_of == "default" else 32
    plan = fbr.k2_plan(batch, params, SMS, limbs, cb=cb)
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs)))
    got = emulate_k2(*args, torch.from_numpy(keys), params, plan)
    plain = fbr.blind_rotate_k2_plain(*args, torch.from_numpy(keys), params)
    assert torch.equal(got.to(torch.int32), plain)
    if plan_of != "default":
        return
    jparams = J.TFHEParams(**vars(params))
    want = jfbr.blind_rotate_fused(
        jnp.asarray(b_init), jnp.asarray(a_t), jnp.asarray(tvs),
        jnp.asarray(np.ascontiguousarray(keys.transpose(0, 2, 1))),
        jparams, True)
    assert np.array_equal(np.asarray(want), plain.numpy())
