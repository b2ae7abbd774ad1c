"""K1's launch plan, the reversed-digit Hankel layout of its key operand, and
a plain emulation of its CUDA schedule.

``k1_plan`` is checked at every preset, at the staged families' shapes and
at native p32, for the main path's batch sizes.  The emulation runs the
kernel's schedule in plain torch: clusters of CTAs that each own a slice of
the (k+1)·N output coefficients and write the digits of their coefficients
reversed within each row into a shared scratch; per chunk and K1_SLICE-byte
contraction slice, the H blocks built from the compact extensions and the
key tile read out of them the way the no-swizzle ``wgmma`` descriptors
address them; int32 partial sums; the limb combine.  It is held bitwise
against ``blind_rotate_k1_plain`` and the JAX ``_kernel_otf`` in interpret
mode, including limb drop and a ragged last tile."""

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
        plan = fbr.k1_plan(batch, params, SMS, limbs)
        assert plan.cb in fbr.K1_TILES and plan.nw in fbr.K1_WIDTHS
        assert fbr.k1_fits(plan.cb, plan.nw, limbs)
        assert 1 <= plan.cluster <= fbr.K1_MAX_CLUSTER
        # each CTA's slice is a whole number of chunks inside one component
        assert kn % (plan.cluster * 2 * plan.nw) == 0
        assert params.poly_size % (2 * plan.nw) == 0
        tiles = -(-batch // plan.cb)
        assert 0 < batch - (tiles - 1) * plan.cb <= plan.cb
        # one wave of CTAs, one an SM
        assert tiles * plan.cluster <= SMS


def test_plan_keeps_one_wave_of_resident_clusters():
    """Clusters the H100 runs at once with one CTA an SM, by cluster size
    (cudaOccupancyMaxActiveClusters for K2 on an H100 80GB HBM3): the main
    path's 1024-ciphertext level takes 16 tiles of 64 on clusters of 6."""
    h100 = {1: 132, 2: 66, 3: 39, 4: 30, 6: 17, 8: 15, 12: 7, 16: 7}
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k1_plan(1024, params, SMS, resident=lambda p: h100[p.cluster])
    assert (plan.cb, plan.cluster, plan.nw) == (64, 6, 64)
    for batch in BATCHES:
        plan = fbr.k1_plan(batch, params, SMS,
                           resident=lambda p: h100[p.cluster])
        assert -(-batch // plan.cb) <= h100[plan.cluster]


def test_plan_overrides_and_refusals():
    params = PRESETS["aes128_p4"][0]
    plan = fbr.k1_plan(1024, params, SMS, cb=128, cluster=3, nw=32)
    assert (plan.cb, plan.cluster, plan.nw) == (128, 3, 32)
    assert fbr.k1_clusters(params, 32) == [12, 8, 6, 4, 3, 2, 1]
    assert fbr.k1_clusters(params, 64) == [12, 6, 4, 3, 2, 1]
    # 128 ciphertexts × 4 limbs × 64 coefficients would take 256 registers
    assert not fbr.k1_fits(128, 64, 4) and fbr.k1_fits(128, 64, 2)
    with pytest.raises(ValueError):
        fbr.k1_plan(1024, params, SMS, cb=128, nw=64)
    # a cluster that does not split the coefficients into whole chunks
    with pytest.raises(ValueError):
        fbr.k1_plan(1024, params, SMS, cluster=5)
    small = TFHEParams(**{**vars(params), "poly_size": 128})
    assert f"multiple of {fbr.K1_SLICE}" in fbr.unsupported(small, otf=True)
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
    """The kernel builds row ii of block w from the 4-byte words around
    8w+ii+1 of one extension; for every chunk and slice the last byte it
    needs is inside the extension (no read past 2N)."""
    for name, params in SHAPES.items():
        N = params.poly_size
        for nw in fbr.K1_WIDTHS:
            cw = 2 * nw
            last = (N - cw) + (N - fbr.K1_SLICE) + 8 * h_blocks(nw) + 15
            assert last == 2 * N - 1, name


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
    ext = keys.long()
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
            g = torch.arange(tile * cb, min((tile + 1) * cb, batch))
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
                            e = ext[i, lb * k1 + comp, row]
                            # the stage's H blocks: E[tc+j0+8w+ii+1+col]
                            off = (tc + j0 + 8 * torch.arange(hb)[:, None]
                                   + torch.arange(8)[None, :] + 1)
                            h = e[off[:, :, None]
                                  + torch.arange(16)].reshape(-1)
                            part[lb] += a @ h[h_index].double().t()
                    # int32 sums: exact and in range
                    assert part.abs().max() < 2 ** 31
                    p = part.long()[:, :len(g)] & MASK
                    add = sum((p[lb] << 8 * (lb + 4 - L)) & MASK
                              for lb in range(L))
                    cols = tc + torch.arange(cw)
                    cur = acc[comp, g[:, None], cols[None, :]]
                    acc[comp, g[:, None], cols[None, :]] = (cur + add) & MASK
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
    plan = fbr.k1_plan(batch, params, SMS, limbs, **kw)
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
    assert "if (lb < 0)" in var["no_build"]
    assert "digit_pass<" not in var["no_digits"]
    assert len({text for text in var.values()}) == len(var)
