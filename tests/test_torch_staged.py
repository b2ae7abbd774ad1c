"""The staged two-family bootstrap of the PyTorch port against the JAX
package, bitwise: ``split_node``, the keys and the staged bootstrap
(generic, and through both fused kernels' plain versions).  The staged
executor is in ``test_torch_staged_executor.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe.staged as JS
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.frontend.mapping.heuristic import HeuristicMapper
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
from tfhe_fbs_map_tpu.tfhe.params import TFHEParams as JParams
import tfhe_fbs_map_tpu_torch.tfhe.staged as TS
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.tfhe.encrypt import lwe_phase
from tfhe_fbs_map_tpu_torch.tfhe.keys import staged_keys_from_numpy
from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
from test_staged_executor import P32_F1, P32_F2

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

# the p=10 families of test_staged_executor.test_staged_executor_p10_...
P10_F1 = JParams(p=10, lwe_dim=16, glwe_dim=1, poly_size=256, bsk_level=3,
                 bsk_base_log=7, ksk_level=4, ksk_base_log=4,
                 lwe_noise_std=2.0, glwe_noise_std=2.0)
P10_F2 = JParams(p=5, lwe_dim=16, glwe_dim=2, poly_size=128, bsk_level=3,
                 bsk_base_log=7, ksk_level=4, ksk_base_log=4,
                 lwe_noise_std=2.0, glwe_noise_std=2.0)
FAMILIES = {32: (P32_F1, P32_F2), 16: (P32_F1, P32_F2), 10: (P10_F1, P10_F2)}


def tp(jparams) -> TFHEParams:
    return TFHEParams(**vars(jparams))


def key_arrays(jk):
    return (tp(jk.params), np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
            np.asarray(jk.bsk), np.asarray(jk.ksk))


def carried(jsk):
    return staged_keys_from_numpy(jsk.p, key_arrays(jsk.keys1),
                                  key_arrays(jsk.keys2), device="cpu")


def mapped(name, p):
    prog = HeuristicMapper(cone_merger="search", fbs_size=p) \
        .map(build_bench(name))
    prog.remove_dangling_nodes()
    return prog


@pytest.fixture(scope="module")
def jkeys32():
    return JS.generate_staged_keys(32, P32_F1, P32_F2, seed=9)


# --------------------------------------------------------------- split_node

# tests/test_staged.py's cases: (coefs, const, table, p, bounds)
SPLIT_CASES = [
    ([1, 2, 4, 8, 16], 0, [0, 1] * 16, 32, None),
    ([1, 2, 4, 8, 16, 32], 0, [0, 1, 1, 0] * 8 + [1, 0, 0, 1] * 8, 32, None),
    ([1] * 31, 0, [0, 1] * 16, 32, None),
    ([1, 2, 4], 0, [0, 1] * 4, 7, None),
    ([1, -2, 16], 0, [0, 1] * 16, 32, None),
    ([1, 2], 0, [0, 1, 1, 0], 32, None),
    ([1, 2, 4, 8], 0, [0, 1, 0, 1], 32, None),
    ([1, 2, 16], -3, [0, 1] * 16, 32, None),
    ([3, -2, 16], 4, [0, 1] * 12, 32, None),
    ([1, -3, 16], 19, [0, 1] * 16 + [1, 0] * 16, 32, None),
    ([3, 16], 0, [0, 1] * 12, 32, [2, 1]),
    ([9, 16], 0, [0, 1] * 16, 32, [2, 1]),
    ([1, 2, 4, 16], 17, [0, 1] * 16 + [1, 0] * 8, 32, None),
    ([1, 2, 4, 8, 16, 32], 0, [1] * 32 + [1] * 16, 32, None),
    ([3, 5, 16], 2, [0, 1] * 14, 32, None),
]


def random_split_case(rng):
    """A random node, biased towards splittable ones: a few small digit
    coefficients, one or two branch coefficients (multiples of m, some
    negative), a binary table, negacyclic at p most times it is longer
    than p, and random wire bounds half the time."""
    p = int(rng.choice([8, 10, 12, 16, 32]))
    m = p // 2
    coefs = [int(c) for c in rng.integers(-1, 3, int(rng.integers(0, 4)))]
    coefs += [m * int(rng.choice([1, 1, 1, 2, -1]))
              for _ in range(int(rng.integers(1, 3)))]
    coefs = [int(c) for c in rng.permutation(coefs)]
    const = int(rng.integers(-1, m))
    tau = int(rng.integers(p + 1, 2 * p + 1) if rng.random() < 0.7
              else rng.integers(m, p + 1))
    table = rng.integers(0, 2, tau).tolist()
    if tau > p and rng.random() < 0.8:
        c = int(rng.integers(0, 3))
        for x in range(tau - p):
            table[x + p] = c - table[x]
    bounds = (None if rng.random() < 0.5
              else rng.integers(1, 3, len(coefs)).tolist())
    return coefs, const, table, p, bounds


def assert_same_split(case):
    coefs, const, table, p, bounds = case
    want = JS.split_node(coefs, const, table, p, bounds=bounds)
    got = TS.split_node(coefs, const, table, p, bounds=bounds)
    if want is None:
        assert got is None, case
    else:
        assert got is not None and vars(got) == vars(want), case
    return want is not None


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_node_equals_jax_on_reference_cases(case):
    assert_same_split(case)


@pytest.mark.parametrize("seed", range(4))
def test_split_node_equals_jax_on_random_nodes(seed):
    rng = np.random.default_rng(seed)
    splits = sum(assert_same_split(random_split_case(rng))
                 for _ in range(100))
    assert splits >= 5          # the random cases reach the split path


# ----------------------------------------------------------------- keys

def assert_same_keys(tk, jk):
    assert vars(tk.params) == vars(jk.params)
    for name in ("lwe_key", "glwe_key", "bsk", "ksk"):
        assert np.array_equal(getattr(tk, name).numpy(),
                              np.asarray(getattr(jk, name))), name


@pytest.mark.parametrize("p,seed", [(32, 9), (10, 13)])
def test_staged_keys_equal_jax(p, seed):
    f1, f2 = FAMILIES[p]
    jsk = JS.generate_staged_keys(p, f1, f2, seed=seed)
    tsk = TS.generate_staged_keys(p, tp(f1), tp(f2), seed=seed,
                                  device="cpu")
    for tk, jk in ((tsk.keys1, jsk.keys1), (tsk.keys2, jsk.keys2)):
        assert_same_keys(tk, jk)
    assert vars(tsk.wire_params) == vars(jsk.wire_params)
    assert np.array_equal(tsk.extracted_key.numpy(),
                          np.asarray(jsk.extracted_key))
    assert np.array_equal(tsk.keys2.extracted_key.numpy(),
                          np.asarray(jsk.extracted_key))
    back = carried(jsk)
    assert back.p == p
    for tk, jk in ((back.keys1, jsk.keys1), (back.keys2, jsk.keys2)):
        assert_same_keys(tk, jk)


def test_generate_keys_checks_given_keys():
    from tfhe_fbs_map_tpu_torch.tfhe.keys import generate_keys
    params = tp(P32_F1)
    with pytest.raises(ValueError):
        generate_keys(params, device="cpu", lwe_key=np.zeros(5, np.int32))
    with pytest.raises(ValueError):
        generate_keys(params, device="cpu", glwe_key=np.zeros(7, np.int32))
    with pytest.raises(ValueError, match="extracted key"):
        TS.generate_staged_keys(32, params, TFHEParams(
            **{**vars(P32_F2), "poly_size": 256}), device="cpu")


# ---------------------------------------------------- staged bootstrap

@pytest.mark.parametrize("coefs,const,table_seed,nega,orients", [
    ([1, 2, 4, 8, 16], 0, 3, False, (None, None)),
    ([1, 2, 4, 8, 16], 0, 3, False, ("fused_otf", "fused_otf")),
    ([1, 2, 4, 8, 16, 32], 0, 4, True, ("fused_otf", "fused")),
    ([3, -2, 16], 4, 11, False, ("fused", "fused_otf")),
])
def test_staged_bootstrap_equals_jax(jkeys32, coefs, const, table_seed,
                                     nega, orients):
    """Same keys, same wires: the port's staged bootstrap (generic, or each
    stage through a fused kernel's plain version) is bitwise equal to the
    JAX one (generic, or Pallas in interpret mode) and decrypts to the
    table."""
    rng = np.random.default_rng(table_seed)
    if nega:
        half = rng.integers(0, 2, 32)
        table = half.tolist() + (1 - half).tolist()
    else:
        lo = sum(min(0, c) for c in coefs) + const
        hi = sum(max(0, c) for c in coefs) + const
        table = rng.integers(0, 2, hi + 1).tolist()
        assert lo >= 0
    split = JS.split_node(coefs, const, table, 32)
    tsplit = TS.split_node(coefs, const, table, 32)
    tsk = carried(jkeys32)
    t = len(coefs)
    combos = np.array([[(j >> i) & 1 for j in range(2 ** t)]
                       for i in range(t)])
    x = np.asarray(coefs) @ combos + const
    jcts = [JS.encrypt_wires(jkeys32, combos[i], np.random.default_rng(i))
            for i in range(t)]
    tcts = [TS.encrypt_wires(tsk, combos[i], np.random.default_rng(i))
            for i in range(t)]
    for a, b in zip(jcts, tcts):
        assert np.array_equal(np.asarray(a), b.numpy())
    jfast = [None if o is None else jprep(k, orientation=o)
             for k, o in zip((jkeys32.keys1, jkeys32.keys2), orients)]
    tfast = [None if o is None else prepare_fast_keys(k, orientation=o)
             for k, o in zip((tsk.keys1, tsk.keys2), orients)]
    want = JS.staged_functional_bootstrap(jkeys32, split, jnp.stack(jcts),
                                          coefs, fast1=jfast[0],
                                          fast2=jfast[1])
    got = TS.staged_functional_bootstrap(tsk, tsplit, torch.stack(tcts),
                                         coefs, fast1=tfast[0],
                                         fast2=tfast[1])
    assert np.array_equal(np.asarray(want), got.numpy())
    u = lwe_phase(tsk.extracted_key, got).numpy().astype(np.uint32)
    dec = np.round(u / tsk.wire_params.delta).astype(np.int64) % 64
    assert np.array_equal(dec, np.asarray(table)[x] % 64)
