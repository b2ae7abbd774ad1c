"""Fast path of the PyTorch port: fused key layouts, both plain kernel
versions and the fast bootstrap, bitwise equal to the JAX package (its
Pallas kernels in interpret mode) and to the generic path.

Shapes: TEST_PARAMS, and a narrow wide-digit shape (k=2, N=512, l=2, b=8,
n=4) with the aes128_p4 preset's GLWE layout.  The CUDA kernels themselves
run only on a GPU: ``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import fused_blind_rotate as jfbr
from tfhe_fbs_map_tpu.ops.blind_rotate import \
    functional_bootstrap_fast as jfast_fbs
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as tfbr
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    functional_bootstrap_fast, keyswitch_fast, prepare_fast_keys)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

WIDE = J.TFHEParams(p=4, lwe_dim=4, glwe_dim=2, poly_size=512, bsk_level=2,
                    bsk_base_log=8, ksk_level=4, ksk_base_log=4,
                    lwe_noise_std=2.0 ** 7, glwe_noise_std=2.0 ** 4)
SHAPES = {"test": J.TEST_PARAMS, "wide": WIDE}


def u32(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


def tparams(p):
    return T.TFHEParams(**vars(p))


_KEYS = {}


def keys_for(shape):
    """JAX keys and the same key material carried into the port."""
    if shape not in _KEYS:
        jk = J.generate_keys(SHAPES[shape], seed=21)
        tk = T.keys_from_numpy(tparams(jk.params), np.asarray(jk.lwe_key),
                               np.asarray(jk.glwe_key), np.asarray(jk.bsk),
                               np.asarray(jk.ksk), device="cpu")
        _KEYS[shape] = (jk, tk)
    return _KEYS[shape]


_FAST = {}


def fast_for(shape, orientation, limbs=4):
    """JAX and port fast keys of one layout, built once per module."""
    key = (shape, orientation, limbs)
    if key not in _FAST:
        jk, tk = keys_for(shape)
        _FAST[key] = (jprep(jk, orientation=orientation, bsk_limbs=limbs),
                      prepare_fast_keys(tk, orientation=orientation,
                                        bsk_limbs=limbs))
    return _FAST[key]


def kernel_args(params, batch, seed):
    """Random operands with the amounts' edge cases in every step."""
    rng = np.random.default_rng(seed)
    N = params.poly_size
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (params.lwe_dim, batch, 1)).astype(np.int32)
    a_t[:, :4, 0] = [0, N - 1, N, 2 * N - 1]
    tvs = rng.integers(0, 1 << 32, (batch, N),
                       dtype=np.uint32).astype(np.int32)
    return b_init, a_t, tvs


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
@pytest.mark.parametrize("limbs", [4, 3])
def test_fast_key_layouts_equal_jax(shape, orientation, limbs):
    want, got = fast_for(shape, orientation, limbs)
    assert got.bsk_kernels.dtype == torch.int8
    assert got.limbs == limbs
    kern = got.bsk_kernels
    if orientation == "fused":
        # K-major: each step's matrix is the JAX one transposed
        assert kern.is_contiguous()
        kern = kern.transpose(1, 2)
    assert np.array_equal(np.asarray(want.bsk_kernels), kern.numpy())
    assert np.array_equal(np.asarray(want.ksk_limbs), got.ksk_limbs.numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
@pytest.mark.parametrize("limbs", [4, 3])
def test_plain_kernels_equal_jax_interpret(shape, orientation, limbs):
    params = SHAPES[shape]
    b_init, a_t, tvs = kernel_args(params, 11, seed=len(shape) + limbs)
    jf, tf = fast_for(shape, orientation, limbs)
    want = jfbr.blind_rotate_fused(jnp.asarray(b_init), jnp.asarray(a_t),
                                   jnp.asarray(tvs), jf.bsk_kernels, params,
                                   True)
    plain = (tfbr.blind_rotate_k1_plain if orientation == "fused_otf"
             else tfbr.blind_rotate_k2_plain)
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs)))
    got = plain(*args, tf.bsk_kernels, tparams(params))
    assert got.shape == (params.glwe_dim + 1, 11, params.poly_size)
    assert np.array_equal(u32(want), u32(got))
    before = dict(tfbr.LAUNCHES)
    via_wrapper = tfbr.blind_rotate_fused(*args, tf.bsk_kernels,
                                          tparams(params))
    assert torch.equal(via_wrapper, got)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert tfbr.LAUNCHES == before


@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_ragged_batch_tiles_equal_jax_slicing(orientation, monkeypatch):
    """21 ciphertexts in tiles of 8 (8, 8, 5), as the JAX lax.map slicing
    with an 8-row VMEM tile."""
    params = SHAPES["test"]
    b_init, a_t, tvs = kernel_args(params, 21, seed=7)
    jf, tf = fast_for("test", orientation)
    monkeypatch.setattr(jfbr, "_max_batch", lambda *a: 8)
    want = jfbr.blind_rotate_fused.__wrapped__(
        jnp.asarray(b_init), jnp.asarray(a_t), jnp.asarray(tvs),
        jf.bsk_kernels, params, True)
    args = tuple(map(torch.from_numpy, (b_init, a_t, tvs)))
    got = tfbr.blind_rotate_fused(*args, tf.bsk_kernels, tparams(params),
                                  batch_tile=8)
    assert np.array_equal(u32(want), u32(got))
    whole = tfbr.blind_rotate_fused(*args, tf.bsk_kernels, tparams(params))
    assert torch.equal(whole, got)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_fast_bootstrap_equals_jax_and_generic(shape, orientation):
    jk, tk = keys_for(shape)
    params = jk.params
    table = [0, 1, 1, 0, 1]
    values = np.arange(len(table))
    cts_j = J.encrypt_values(jk, values, np.random.default_rng(1))
    cts_t = T.encrypt_values(tk, values, np.random.default_rng(1))
    tv, post = T.build_test_vector(table, tparams(params))
    tvs = np.broadcast_to(tv, (len(table), params.poly_size)).copy()
    posts = np.full(len(table), np.int32(post))
    jf, fast = fast_for(shape, orientation)
    want = jfast_fbs(jf, cts_j, jnp.asarray(tvs), jnp.asarray(posts))
    got = functional_bootstrap_fast(fast, cts_t, torch.from_numpy(tvs),
                                    torch.from_numpy(posts))
    generic = T.functional_bootstrap(tk, cts_t, torch.from_numpy(tvs),
                                     torch.from_numpy(posts))
    assert np.array_equal(u32(want), u32(got))
    assert torch.equal(got, generic)
    assert np.array_equal(T.decrypt_values(tk, got), np.asarray(table))
    # the int8-limb key switch equals the generic one (M < 17: padded)
    assert torch.equal(keyswitch_fast(cts_t, fast), T.keyswitch(cts_t, tk))


def test_cuda_wrapper_checks_inputs():
    """The launch path refuses mismatched operands before touching CUDA."""
    _, fast = fast_for("test", "fused")
    params = fast.params
    b_init, a_t, tvs = map(torch.from_numpy, kernel_args(params, 5, seed=2))
    with pytest.raises(ValueError):
        tfbr._launch_k2(b_init.long(), a_t, tvs, fast.bsk_kernels, params,
                        None, None)
    with pytest.raises(ValueError):
        tfbr._launch_k1(b_init, a_t, tvs, fast.bsk_kernels, params, None,
                        None, None)
    # the JAX layout (not K-major) is refused
    with pytest.raises(ValueError):
        tfbr._launch_k2(b_init, a_t, tvs,
                        fast.bsk_kernels.transpose(1, 2).contiguous(),
                        params, None, None)
