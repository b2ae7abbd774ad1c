"""TFHE core of the PyTorch port bitwise equal to the JAX package: keys,
ciphertexts, the generic bootstrap, and the key file format."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
import tfhe_fbs_map_tpu.tfhe.keys as jkeys_mod
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch.tfhe import pbs as tpbs

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

P = J.TEST_PARAMS


def u32(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x).astype(np.int64).astype(np.uint32)


@pytest.fixture(scope="module")
def both_keys():
    return J.generate_keys(P, seed=11), T.generate_keys(T.TEST_PARAMS,
                                                        seed=11,
                                                        device="cpu")


def test_params_copied():
    for name in ("TEST_PARAMS", "DEFAULT_PARAMS", "FAST_PARAMS"):
        assert vars(getattr(J, name)) == vars(getattr(T, name))
    for n in (16, 578, 630, 1024, 5000):
        assert J.params.min_noise_std_rel(n) == \
            T.params.min_noise_std_rel(n)


@pytest.mark.parametrize("seed", [0, 11])
def test_generate_keys_bitwise(seed, both_keys):
    jk, tk = both_keys if seed == 11 else (
        J.generate_keys(P, seed=seed),
        T.generate_keys(T.TEST_PARAMS, seed=seed, device="cpu"))
    for name in ("lwe_key", "glwe_key", "bsk", "ksk"):
        want, got = getattr(jk, name), getattr(tk, name)
        assert tuple(want.shape) == tuple(got.shape), name
        assert got.dtype == torch.int32, name
        assert np.array_equal(u32(want), u32(got)), name
    assert np.array_equal(u32(jk.extracted_key), u32(tk.extracted_key))


def test_encrypt_values_bitwise(both_keys):
    jk, tk = both_keys
    vals = np.arange(2 * P.p)
    want = J.encrypt_values(jk, vals, np.random.default_rng(3))
    got = T.encrypt_values(tk, vals, np.random.default_rng(3))
    assert np.array_equal(u32(want), u32(got))
    assert np.array_equal(T.decrypt_values(tk, got), vals)
    assert np.array_equal(u32(J.lwe_phase(jk.extracted_key, want)),
                          u32(T.lwe_phase(tk.extracted_key, got)))
    lin_j = J.lwe_lincomb(want[:3], [2, -1, 3], 1, P)
    lin_t = T.lwe_lincomb(got[:3], [2, -1, 3], 1, P)
    assert np.array_equal(u32(lin_j), u32(lin_t))


def test_keyswitch_and_external_product_bitwise(both_keys):
    jk, tk = both_keys
    rng = np.random.default_rng(6)
    big = rng.integers(0, 1 << 32, (5, P.big_dim + 1),
                       dtype=np.uint32).astype(np.int32)
    assert np.array_equal(u32(J.keyswitch(jnp.asarray(big), jk)),
                          u32(T.keyswitch(torch.from_numpy(big), tk)))
    glwe = rng.integers(0, 1 << 32, (3, P.glwe_dim + 1, P.poly_size),
                        dtype=np.uint32).astype(np.int32)
    for i in (0, P.lwe_dim - 1):
        want = J.external_product(jnp.asarray(glwe), jk.bsk[i], P)
        got = T.external_product(torch.from_numpy(glwe), tk.bsk[i], P)
        assert np.array_equal(u32(want), u32(got)), i


@pytest.mark.parametrize("table", [
    [0, 1, 0, 1],            # tau = p
    [0, 1, 1],               # tau < p
    [1, 0, 2, 1],            # multi-value
    [0, 1, 1, 0, 1, 0, 0, 1],  # tau = 2p, mode1
    [0, 1, 1, 0, 1],         # tau = p+1, mode1
    [0, 1, 1, 0, 0],         # tau = p+1, mode2 (overlap 0)
    [1, 1, 0, 1, 1],         # tau = p+1, mode3 (overlap 1)
])
def test_functional_bootstrap_bitwise(both_keys, table):
    jk, tk = both_keys
    tau = len(table)
    values = np.arange(tau)
    cts_j = J.encrypt_values(jk, values, np.random.default_rng(8))
    cts_t = T.encrypt_values(tk, values, np.random.default_rng(8))
    tv, post = T.build_test_vector(table, P)
    tv_j, post_j = J.build_test_vector(table, P)
    assert np.array_equal(tv, tv_j) and post == post_j
    tvs = np.broadcast_to(tv, (tau, P.poly_size)).copy()
    posts = np.full(tau, np.uint32(post).astype(np.int32))
    want = J.functional_bootstrap(jk, cts_j, jnp.asarray(tvs),
                                  jnp.asarray(posts))
    got = T.functional_bootstrap(tk, cts_t, torch.from_numpy(tvs),
                                 torch.from_numpy(posts))
    assert np.array_equal(u32(want), u32(got))
    assert np.array_equal(T.decrypt_values(tk, got), np.asarray(table))


def test_key_files_move_between_packages(tmp_path, both_keys):
    jk, tk = both_keys
    path = str(tmp_path / "jax_keys.npz")
    jkeys_mod.save_keys(path, jk)
    loaded = T.load_keys(path, device="cpu")
    assert loaded.params == tk.params
    for name in ("lwe_key", "glwe_key", "bsk", "ksk"):
        assert torch.equal(getattr(loaded, name), getattr(tk, name)), name
    path2 = str(tmp_path / "torch_keys.npz")
    T.save_keys(path2, tk)
    back = jkeys_mod.load_keys(path2)
    assert back.params == jk.params
    assert np.array_equal(u32(back.bsk), u32(jk.bsk))
    carried = T.keys_from_numpy(P, np.asarray(jk.lwe_key),
                                np.asarray(jk.glwe_key), np.asarray(jk.bsk),
                                np.asarray(jk.ksk), device="cpu")
    assert torch.equal(carried.ksk, tk.ksk)


def test_sample_extract_and_modswitch(both_keys):
    rng = np.random.default_rng(12)
    acc = rng.integers(0, 1 << 32, (4, P.glwe_dim + 1, P.poly_size),
                       dtype=np.uint32).astype(np.int32)
    want = J.sample_extract(jnp.asarray(acc), P)
    got = T.sample_extract(torch.from_numpy(acc), P)
    assert np.array_equal(u32(want), u32(got))
    x = acc.reshape(-1)[:500]
    from tfhe_fbs_map_tpu.tfhe.pbs import modswitch as jmod
    assert np.array_equal(np.asarray(jmod(jnp.asarray(x), P)),
                          tpbs.modswitch(torch.from_numpy(x), P).numpy())
