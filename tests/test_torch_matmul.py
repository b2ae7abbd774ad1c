"""The port's ``"matmul"`` orientation (``ops/blind_rotate.py``) on the CPU,
bitwise against the JAX package's XLA matmul orientation at
``TEST_PARAMS``: the key matrices (up to the layout's transpose), the
rotation, the per-step external product, the whole FBS at 4 and 3 key
limbs (and against the port's fused plain paths), the key-contraction
slices tp positions hold, and the entry points that take the orientation:
the runtime CLI, the bench and ``runtime.profile``'s step variants.  The
tolerance of every comparison is 0."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops.blind_rotate import (
    external_product_conv, functional_bootstrap_fast as jfbs,
    prepare_fast_keys as jprep)
from tfhe_fbs_map_tpu.ops.polymul import monomial_rotate_onehot
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch import bench
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    bootstrap_matmul, functional_bootstrap_fast, key_product,
    prepare_fast_keys, rotate, shard_contraction, step_digits)
from tfhe_fbs_map_tpu_torch.runtime import profile
from tfhe_fbs_map_tpu_torch.runtime.cli import main as cli_main
from tfhe_fbs_map_tpu_torch.tfhe.keys import keys_from_numpy
from tfhe_fbs_map_tpu_torch.tfhe.numeric import I64, int8_matmul_nt, wrap32

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

PARAMS = J.TEST_PARAMS
BATCH = 8


@pytest.fixture(scope="module")
def keys():
    """JAX keys at TEST_PARAMS and the port's copy of the same bytes."""
    jk = J.generate_keys(PARAMS, seed=3)
    tk = keys_from_numpy(T.TFHEParams(**vars(jk.params)),
                         np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
                         np.asarray(jk.bsk), np.asarray(jk.ksk), device="cpu")
    return jk, tk


@pytest.fixture(scope="module")
def jax_fast(keys):
    """JAX's matmul keys at 4 and 3 limbs, built once."""
    return {limbs: jprep(keys[0], "matmul", limbs) for limbs in (4, 3)}


@pytest.fixture(scope="module")
def inputs(keys):
    """BATCH ciphertexts of values in [0, 3) with a 3-entry table: the JAX
    arrays and the port's tensors."""
    jk = keys[0]
    rng = np.random.default_rng(4)
    values = rng.integers(0, 3, BATCH)
    cts = J.encrypt_values(jk, values, rng)
    tv, post = J.build_test_vector([1, 0, 1], PARAMS)
    tvs = jnp.broadcast_to(jnp.asarray(tv), (BATCH, PARAMS.poly_size))
    posts = jnp.full((BATCH,), np.int32(np.int64(post).astype(np.uint32)
                                        .astype(np.int32)))
    jargs = (cts, tvs, posts)
    return values, jargs, [torch.from_numpy(np.array(x)) for x in jargs]


@pytest.mark.parametrize("limbs", [4, 3])
def test_keys_equal_jax_up_to_the_transpose(keys, jax_fast, limbs):
    """One layout for "fused" and "matmul", as in JAX: each step's
    [D, T] matrix is the transpose of JAX's [T, D]; the key switch's
    limbs are JAX's."""
    fast = prepare_fast_keys(keys[1], "matmul", limbs)
    jf = jax_fast[limbs]
    assert fast.orientation == "matmul" and fast.shard == (0, 1)
    assert fast.limbs == limbs
    assert np.array_equal(fast.bsk_kernels.numpy(),
                          np.asarray(jf.bsk_kernels).transpose(0, 2, 1))
    assert np.array_equal(fast.ksk_limbs.numpy(), np.asarray(jf.ksk_limbs))
    assert torch.equal(fast.bsk_kernels, prepare_fast_keys(
        keys[1], "fused", limbs).bsk_kernels)


def test_rotation_equals_jax_one_hot_rotation():
    """X^a·ACC by the gather from [ACC, -ACC] equals JAX's one-hot
    rotation, the amounts' edge cases 0, N-1, N and 2N-1 included."""
    N = PARAMS.poly_size
    rng = np.random.default_rng(5)
    acc = rng.integers(-2 ** 31, 2 ** 31, (12, 2, N)).astype(np.int32)
    amounts = rng.integers(0, 2 * N, 12).astype(np.int32)
    amounts[:4] = [0, N - 1, N, 2 * N - 1]
    want = np.asarray(monomial_rotate_onehot(jnp.asarray(acc),
                                             jnp.asarray(amounts)))
    got = wrap32(rotate(torch.from_numpy(acc), torch.from_numpy(amounts)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,l", [(8, 2), (7, 3), (8, 4), (4, 8), (1, 20),
                                 (2, 16)])
def test_step_digits_equal_the_gadget_decomposition(b, l):
    """The carry-free digits (an offset, then plain base-B digits) equal
    ``gadget_decompose``'s balanced ones, at every base the int8 operand
    takes (b ≤ 8), b·l = 32 (no rounding) included, on random and edge
    values."""
    from dataclasses import replace
    from tfhe_fbs_map_tpu_torch.tfhe.numeric import gadget_decompose
    params = replace(T.TEST_PARAMS, bsk_base_log=b, bsk_level=l)
    rng = np.random.default_rng(b * 100 + l)
    x = rng.integers(-2 ** 31, 2 ** 31, (6, 2, 16)).astype(np.int64)
    x[0, 0, :8] = [0, -1, 1, 2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30,
                   (1 << (32 - b * l)) // 2 if b * l < 32 else 7]
    x = torch.from_numpy(x)
    want = gadget_decompose(x, b, l).permute(0, 1, 3, 2).reshape(6, -1)
    assert torch.equal(step_digits(x, params).to(torch.int32), want)
    # an int64 value congruent mod 2^32 gives the same digits
    assert torch.equal(step_digits(x + 3 * 2 ** 32, params),
                       step_digits(x, params))


@pytest.mark.parametrize("limbs,step", [(4, 0), (4, 9), (3, 5)])
def test_external_product_equals_jax(keys, jax_fast, limbs, step):
    """The digits of a random difference times a step's matrix, limbs
    combined: ``external_product_conv(..., "matmul")``."""
    fast = prepare_fast_keys(keys[1], "matmul", limbs)
    rng = np.random.default_rng(6 + step)
    diff = rng.integers(-2 ** 31, 2 ** 31, (BATCH, 2, PARAMS.poly_size)) \
        .astype(np.int32)
    want = np.asarray(external_product_conv(
        jnp.asarray(diff), jax_fast[limbs].bsk_kernels[step], PARAMS,
        "matmul"))
    flat = step_digits(torch.from_numpy(diff).to(I64), fast.params)
    got = wrap32(key_product(flat, fast, step)).view(diff.shape)
    assert np.array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def jax_fbs(jax_fast, inputs):
    return {limbs: np.asarray(jfbs(jax_fast[limbs], *inputs[1]))
            for limbs in (4, 3)}


@pytest.mark.parametrize("limbs", [4, 3])
def test_fbs_equals_jax_and_the_fused_paths(keys, jax_fbs, inputs, limbs):
    """The whole FBS through "matmul" equals JAX's matmul FBS and the
    port's K2 and K1 plain versions on the same keys; at 4 limbs it
    decrypts to the table."""
    values, _, args = inputs
    got = functional_bootstrap_fast(prepare_fast_keys(keys[1], "matmul",
                                                      limbs), *args)
    assert np.array_equal(got.numpy(), jax_fbs[limbs])
    for orientation in ("fused", "fused_otf"):
        other = functional_bootstrap_fast(
            prepare_fast_keys(keys[1], orientation, limbs), *args)
        assert torch.equal(got, other), orientation
    if limbs == 4:
        assert np.array_equal(T.decrypt_values(keys[1], got),
                              np.asarray([1, 0, 1])[values])


@pytest.mark.parametrize("tp", [2, 3, 4])
def test_contraction_slices_add_up_to_the_whole(keys, inputs, tp):
    """Slice j of tp holds the columns [j·w, (j+1)·w) of every step's
    matrix (w a multiple of 8, the last slice zero-padded where tp does
    not divide rows·N = 1536) and its share of the key switch's rows; the
    slices' FBS, their partials summed, equals the whole key's at every
    position."""
    fast = prepare_fast_keys(keys[1], "matmul")
    t = fast.bsk_kernels.shape[2]
    shards = [shard_contraction(fast, j, tp) for j in range(tp)]
    w = shards[0].bsk_kernels.shape[2]
    assert w % 8 == 0 and w * tp >= t > w * (tp - 1)
    whole = torch.cat([s.bsk_kernels for s in shards], dim=2)
    assert torch.equal(whole[:, :, :t], fast.bsk_kernels)
    assert not whole[:, :, t:].any()
    rows = fast.ksk_matrix.shape[0]
    ksk = torch.cat([s.ksk_matrix for s in shards])
    assert torch.equal(ksk[:rows], fast.ksk_matrix) and not ksk[rows:].any()
    assert [s.shard for s in shards] == [(j, tp) for j in range(tp)]
    assert {s.limbs for s in shards} == {fast.limbs} == {4}
    args = inputs[2]
    want = functional_bootstrap_fast(fast, *args)
    outs = bootstrap_matmul(shards, *([x] * tp for x in args))
    assert len(outs) == tp and all(torch.equal(o, want) for o in outs)
    with pytest.raises(ValueError, match="whole"):
        shard_contraction(shards[0], 0, 2)


def test_int8_matmul_nt():
    """a @ b_t.T through ``_int_mm`` on b_t's transposed view: exact at
    M < 17, and it refuses a b_t it would have to copy."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.integers(-128, 128, (5, 64)).astype(np.int8))
    b_t = torch.from_numpy(rng.integers(-128, 128, (24, 64)).astype(np.int8))
    want = a.to(I64) @ b_t.to(I64).t()
    assert torch.equal(int8_matmul_nt(a, b_t).to(I64), want)
    with pytest.raises(ValueError, match="row-major"):
        int8_matmul_nt(a, b_t.t().contiguous().t())
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_matmul_nt(a[:, :60], b_t[:, :60])


def test_cli_runs_matmul(tmp_path, capsys):
    from tfhe_fbs_map_tpu.frontend.circuits import build_bench
    path = tmp_path / "fa.blif"
    with open(path, "w") as f:
        build_bench("full_adder").to_blif(f, model_name="fa")
    assert cli_main([str(path), "--map", "--batch", "4", "--device", "cpu",
                     "--test-params", "--orientation", "matmul"]) == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert res["bit_exact"] and res["orientation"] == "matmul"
    assert res["mesh"] is None and "# fast keys (matmul)" in out.err


@pytest.mark.parametrize("limbs", ["4", "3"])
def test_bench_quick_matmul_on_the_cpu(capsys, limbs):
    """``bench --orientation matmul --quick --device cpu``: the JAX bench's
    quick set through the orientation, at 4 and at 3 key limbs."""
    assert bench.main(["--quick", "--device", "cpu", "--orientation",
                       "matmul", "--bsk-limbs", limbs, "--iters", "2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["orientation"] == "matmul" and res["errors"] == 0
    assert res["bsk_limbs"] == int(limbs) and res["params"]["N"] == 128


def test_profile_step_variants_on_the_cpu(capsys):
    """``runtime.profile --step-variants``: one JSON line a variant of
    ``experiments/profile_step.py`` (and the product alone), with µs a
    step and the boots/s it implies at the anchor's n."""
    assert profile.main(["--step-variants", "--device", "cpu", "--batch",
                         "16", "--steps", "2", "--iters", "1"]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["variant"] for x in lines] == list(profile.VARIANTS) == [
        "full", "rot_only", "mm_only", "dec_only", "mm_rot", "int_mm"]
    for x in lines:
        assert x["us_per_step"] > 0 and x["n"] == 546 and x["batch"] == 16
        assert x["ms_per_launch"] == pytest.approx(
            x["us_per_step"] * 546 / 1e3, rel=1e-3)
        assert x["implied_boots_per_s"] > 0
