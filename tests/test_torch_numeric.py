"""Torus arithmetic and polynomial helpers of the PyTorch port, digit-exact
against the JAX package on random uint32 inputs (zero tolerance: all
arithmetic is exact mod 2^32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu.ops import polymul as jpoly
from tfhe_fbs_map_tpu.tfhe import numeric as jnum
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as tfbr
from tfhe_fbs_map_tpu_torch.ops import polymul as tpoly
from tfhe_fbs_map_tpu_torch.tfhe import numeric as tnum

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

BASES = [2, 3, 6, 7, 8]
N = 64
EDGES = [0, N - 1, N, 2 * N - 1]


def u32(x):
    """uint32 view of a JAX array, numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def rand_torus(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, shape, dtype=np.uint32).astype(np.int32)
    x.flat[:4] = [0, -1, -2 ** 31, 2 ** 31 - 1]
    return x


@pytest.mark.parametrize("b", BASES)
def test_gadget_decompose_matches_jax(b):
    x = rand_torus((37, 11), b)
    l = 32 // b
    want = jnum.gadget_decompose(jnp.asarray(x), b, l)
    got = tnum.gadget_decompose(torch.from_numpy(x), b, l)
    assert got.dtype == torch.int32
    assert np.array_equal(u32(want), u32(got))
    back = tnum.gadget_recompose(got, b)
    assert np.array_equal(u32(jnum.gadget_recompose(want, b)), u32(back))


@pytest.mark.parametrize("b", BASES)
def test_signed_limbs_matches_jax(b):
    x = rand_torus((53,), 10 + b)
    n_limbs = -(-32 // b)
    want = jnum.signed_limbs(jnp.asarray(x), n_limbs, b)
    got = tnum.signed_limbs(torch.from_numpy(x), n_limbs, b)
    assert np.array_equal(u32(want), u32(got))


@pytest.mark.parametrize("b", BASES)
def test_round_shift_right_matches_jax(b):
    x = rand_torus((101,), 20 + b)
    for shift in (0, 32 - b * (32 // b), 32 - b, 31):
        want = jnum.round_shift_right(jnp.asarray(x), shift)
        got = tnum.round_shift_right(torch.from_numpy(x), shift)
        assert np.array_equal(np.asarray(want).astype(np.int64),
                              got.numpy()), shift


@pytest.mark.parametrize("b", BASES)
def test_biased_digits_equal_gadget_decompose(b):
    """The kernels' biased-add digits equal the carry-loop decomposition."""
    l = (31 // b)
    x = torch.from_numpy(rand_torus((9, N), 30 + b))
    want = tnum.gadget_decompose(x, b, l)
    got = torch.stack(tfbr.decompose_digits(x, b, l), dim=-1)
    assert torch.equal(want, got)
    jax_digits = jfbr._decompose_digits(jnp.asarray(x.numpy()), b, l)
    assert np.array_equal(u32(jnp.stack(jax_digits, axis=-1)), u32(got))


def test_wrap32_and_exact_matmuls():
    rng = np.random.default_rng(4)
    big = rng.integers(-2 ** 40, 2 ** 40, 1000)
    assert np.array_equal(tnum.wrap32(torch.from_numpy(big)).numpy(),
                          big.astype(np.uint32).astype(np.int32))
    small = rng.integers(-128, 128, (5, 300))
    torus = rand_torus((300, 13), 5)
    want = (small @ torus.astype(np.int64)).astype(np.uint32)
    got = tnum.exact_matmul(torch.from_numpy(small), torch.from_numpy(torus))
    assert np.array_equal(u32(got), want)
    # int8 @ int8 wraps in torch: the padded _int_mm path must not
    a8 = rng.integers(-128, 128, (3, 13)).astype(np.int8)
    b8 = rng.integers(-128, 128, (13, 5)).astype(np.int8)
    got8 = tnum.int8_matmul(torch.from_numpy(a8), torch.from_numpy(b8))
    assert got8.dtype == torch.int32 and got8.shape == (3, 5)
    assert np.array_equal(got8.numpy(), a8.astype(np.int64)
                          @ b8.astype(np.int64))


@pytest.mark.parametrize("amount", EDGES + [17, 77])
def test_monomial_rotate_matches_jax(amount):
    poly = rand_torus((3, 2, N), amount)
    amt = np.full((3, 2), amount)
    amt[0, 0] = (amount + 5) % (2 * N)
    want = jpoly.monomial_rotate(jnp.asarray(poly), jnp.asarray(amt))
    got = tpoly.monomial_rotate(torch.from_numpy(poly), torch.from_numpy(amt))
    assert np.array_equal(u32(want), u32(got))


@pytest.mark.parametrize("amount", EDGES + [1, 33])
def test_barrel_rotate_matches_jax_and_monomial(amount):
    x = rand_torus((6, N), 40 + amount)
    amt = np.full((6, 1), amount, dtype=np.int32)
    amt[1, 0] = 2 * N - 1 - amount
    want = jfbr._barrel_rotate(jnp.asarray(x), jnp.asarray(amt), True)
    got = tfbr.barrel_rotate(torch.from_numpy(x), torch.from_numpy(amt))
    assert np.array_equal(u32(want), u32(got))
    mono = tpoly.monomial_rotate(torch.from_numpy(x),
                                 torch.from_numpy(amt[:, 0]))
    assert torch.equal(mono, got)


def test_negacyclic_matrix_matches_jax():
    poly = rand_torus((2, 3, N), 50)
    want = jpoly.negacyclic_matrix(jnp.asarray(poly))
    got = tpoly.negacyclic_matrix(torch.from_numpy(poly))
    assert np.array_equal(u32(want), u32(got))
    stack = jpoly.negacyclic_rotation_stack(jnp.asarray(poly))
    assert np.array_equal(u32(stack),
                          u32(tpoly.negacyclic_rotation_stack(
                              torch.from_numpy(poly))))
