"""The port's conv orientations ``keys_rhs``, ``keys_lhs`` and
``keys_lhs_bf16`` (``ops/blind_rotate.py``) on the CPU, bitwise against the
JAX package at ``TEST_PARAMS``: the key layouts, ``external_product_conv``
at steps 0, 3 and n−1 in every orientation (and against the port's generic
external product), the whole FBS, and ``negacyclic_polymul`` with its numpy
copy; then the refusals of the entry points (b = 8, ``--bsk-limbs 3``,
tp = 2, a staged run under a mesh) and ``--orientation auto``, which picks
no conv orientation.  The tolerance of every comparison is 0."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.ops import polymul as jpoly
from tfhe_fbs_map_tpu.ops.blind_rotate import (
    external_product_conv as jexternal, functional_bootstrap_fast as jfbs,
    prepare_fast_keys as jprep)
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch import bench, ops
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    CONV_ORIENTATIONS, ORIENTATIONS, conv_step_matrix, conv_unsupported,
    external_product_conv, functional_bootstrap_fast, prepare_fast_keys)
from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import pick_kernel
from tfhe_fbs_map_tpu_torch.runtime.cli import main as cli_main
from tfhe_fbs_map_tpu_torch.runtime.cli import pick_orientations
from tfhe_fbs_map_tpu_torch.tfhe.keys import keys_from_numpy, save_keys

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

PARAMS = J.TEST_PARAMS
BATCH = 5
STEPS = (0, 3, PARAMS.lwe_dim - 1)


def carried(jk):
    return keys_from_numpy(T.TFHEParams(**vars(jk.params)),
                           np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
                           np.asarray(jk.bsk), np.asarray(jk.ksk),
                           device="cpu")


@pytest.fixture(scope="module")
def keys():
    """JAX keys at TEST_PARAMS (the seed of ``tests/test_fast_path.py``)
    and the port's copy of the same bytes."""
    jk = J.generate_keys(PARAMS, seed=13)
    return jk, carried(jk)


@pytest.fixture(scope="module")
def fast(keys):
    """Each orientation's keys in both packages, built once."""
    return {o: (jprep(keys[0], o), prepare_fast_keys(keys[1], o))
            for o in CONV_ORIENTATIONS + ("matmul",)}


def as_numpy(x):
    """A key tensor as numpy (bf16 through float32, which holds it)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("orientation,dtype,width", [
    ("keys_rhs", torch.int8, 1), ("keys_lhs", torch.int8, 2),
    ("keys_lhs_bf16", torch.bfloat16, 2)])
def test_keys_equal_jax(fast, orientation, dtype, width):
    """[n, (k+1)·4, rows, N or 2N] in JAX's dtype and bytes; the key
    switch's limbs are JAX's."""
    jf, tf = fast[orientation]
    k1, N = PARAMS.glwe_dim + 1, PARAMS.poly_size
    assert tf.orientation == orientation and tf.bsk_kernels.dtype == dtype
    assert tf.limbs == 4
    assert tuple(tf.bsk_kernels.shape) == (
        PARAMS.lwe_dim, 4 * k1, k1 * PARAMS.bsk_level, width * N)
    assert np.array_equal(as_numpy(tf.bsk_kernels), as_numpy(jf.bsk_kernels))
    assert np.array_equal(tf.ksk_limbs.numpy(), np.asarray(jf.ksk_limbs))
    moved = tf.to("meta")
    assert moved.bsk_kernels.is_meta and moved.orientation == orientation
    assert moved.bsk_kernels.dtype == dtype


def test_lhs_key_is_k1_compact_key_reordered(fast):
    """keys_lhs holds K1's compact key, limb-major there and
    component-major here: [n, 4·(k+1), rows, 2N] against [n, (k+1)·4,
    rows, 2N]."""
    k1 = PARAMS.glwe_dim + 1
    lhs = fast["keys_lhs"][1].bsk_kernels
    otf = prepare_fast_keys(carried(J.generate_keys(PARAMS, seed=13)),
                            "fused_otf").bsk_kernels
    n, _, rows, width = otf.shape
    reordered = otf.view(n, 4, k1, rows, width).transpose(1, 2)
    assert torch.equal(lhs, reordered.reshape(lhs.shape))


@pytest.mark.parametrize("orientation", CONV_ORIENTATIONS + ("matmul",))
@pytest.mark.parametrize("step", STEPS)
def test_external_product_equals_jax_and_generic(keys, fast, orientation,
                                                 step):
    """``external_product_conv`` on a random difference at steps 0, 3 and
    n−1 (``tests/test_fast_path.py``'s cases): JAX's int32 output in
    every branch, and the port's generic external product."""
    rng = np.random.default_rng(0)
    diff = rng.integers(0, 1 << 32, (BATCH, PARAMS.glwe_dim + 1,
                                     PARAMS.poly_size),
                        dtype=np.uint32).astype(np.int32)
    jf, tf = fast[orientation]
    want = np.asarray(jexternal(jnp.asarray(diff), jf.bsk_kernels[step],
                                PARAMS, orientation))
    got = external_product_conv(torch.from_numpy(diff),
                                tf.bsk_kernels[step], tf.params, orientation)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    generic = T.external_product(torch.from_numpy(diff), keys[1].bsk[step],
                                 tf.params)
    assert torch.equal(got, generic)


@pytest.mark.parametrize("orientation", ["keys_rhs", "keys_lhs"])
def test_step_matrix_is_one_copy_of_the_windows(fast, orientation):
    """A step's B operand is row-major [(k+1)·4·N, C] int8 with C = rows·N
    (keys_lhs) or rows·2N (keys_rhs), 18.9 and 37.7 MB at (k=2, N=512,
    l=2); here its rows are the key's windows."""
    tf = fast[orientation][1]
    k1, N = PARAMS.glwe_dim + 1, PARAMS.poly_size
    rows = k1 * PARAMS.bsk_level
    kern = tf.bsk_kernels[2]
    mat = conv_step_matrix(kern, tf.params, orientation)
    width = N if orientation == "keys_lhs" else 2 * N
    assert mat.shape == (4 * k1 * N, rows * width) and mat.is_contiguous()
    g, t, r = 5, 7, 4
    row = mat[g * N + t].view(rows, width)[r]
    if orientation == "keys_lhs":
        assert torch.equal(row, kern[g, r, t + 1:t + 1 + N])
    else:
        padded = torch.cat([kern.new_zeros(N - 1), kern[g, r].flip(0),
                            kern.new_zeros(N)])
        assert torch.equal(row, padded[t:t + 2 * N])


@pytest.fixture(scope="module")
def inputs(keys):
    """BATCH ciphertexts of [0, 5) under the table [0, 1, 1, 0, 1] (the
    full-bootstrap case of ``tests/test_fast_path.py``)."""
    rng = np.random.default_rng(1)
    table = [0, 1, 1, 0, 1]
    values = np.arange(len(table))
    cts = J.encrypt_values(keys[0], values, rng)
    tv, post = J.build_test_vector(table, PARAMS)
    tvs = jnp.broadcast_to(jnp.asarray(tv), (len(table), PARAMS.poly_size))
    posts = jnp.full((len(table),), np.int32(post))
    jargs = (cts, tvs, posts)
    return (np.asarray(table)[values], jargs,
            [torch.from_numpy(np.array(x)) for x in jargs])


@pytest.mark.parametrize("orientation", CONV_ORIENTATIONS)
def test_fbs_equals_jax_and_k1(keys, fast, inputs, orientation):
    """The whole FBS (key switch, modswitch, ACC, n steps of rotation and
    ``external_product_conv``, sample extract) equals JAX's, the port's K1
    plain path on the same keys, and decrypts to the table."""
    want_values, jargs, args = inputs
    jf, tf = fast[orientation]
    got = functional_bootstrap_fast(tf, *args)
    assert np.array_equal(got.numpy(), np.asarray(jfbs(jf, *jargs)))
    k1 = functional_bootstrap_fast(prepare_fast_keys(keys[1], "fused_otf"),
                                   *args)
    assert torch.equal(got, k1)
    assert np.array_equal(T.decrypt_values(keys[1], got), want_values)


# ------------------------------------------------------------ polymul

@pytest.mark.parametrize("n", [8, 64])
def test_negacyclic_polymul_equals_jax(n):
    """``tests/test_tfhe_core.py``'s known-answer case: small digits times
    a torus polynomial, one at a time and batched over [3, 2]."""
    rng = np.random.default_rng(2)
    a = rng.integers(-100, 100, (3, 2, n)).astype(np.int32)
    b = rng.integers(0, 1 << 32, (3, 2, n), dtype=np.uint32) \
        .astype(np.int32)
    want = np.asarray(jpoly.negacyclic_polymul(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = ops.negacyclic_polymul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    for i in range(3):
        host = ops.np_negacyclic_polymul(a[i, 0], b[i, 0])
        assert host.dtype == np.int32
        assert np.array_equal(host, jpoly.np_negacyclic_polymul(a[i, 0],
                                                                b[i, 0]))
        assert np.array_equal(host, want[i, 0])


def test_negacyclic_polymul_torus_operands_and_x_to_the_n():
    """Both operands full torus values (products wrap mod 2^32), and X ·
    X^(N−1) = −1."""
    rng = np.random.default_rng(3)
    a, b = (rng.integers(0, 1 << 32, (4, 32), dtype=np.uint32)
            .astype(np.int32) for _ in range(2))
    want = np.asarray(jpoly.negacyclic_polymul(jnp.asarray(a),
                                               jnp.asarray(b)))
    got = ops.negacyclic_polymul(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.np_negacyclic_polymul(a[0], b[0]), want[0])
    n = 16
    x1, xn1 = np.zeros(n, np.int32), np.zeros(n, np.int32)
    x1[1], xn1[n - 1] = 1, 1
    one = ops.negacyclic_polymul(torch.from_numpy(x1), torch.from_numpy(xn1))
    assert one.tolist() == [-1] + [0] * (n - 1)


@pytest.mark.parametrize("amount", [0, 1, 5, 31, 32, 35, 63])
def test_monomial_rotate_matches_polymul(amount):
    """X^amount · poly by the rotation equals the product with the
    monomial, as in ``tests/test_tfhe_core.py``."""
    rng = np.random.default_rng(3)
    n = 32
    poly = rng.integers(0, 1 << 32, n, dtype=np.uint32).astype(np.int32)
    mono = np.zeros(n, dtype=np.int32)
    mono[amount % n] = 1 if amount < n else -1
    want = ops.np_negacyclic_polymul(mono, poly)
    got = ops.monomial_rotate(torch.from_numpy(poly)[None, :],
                              torch.tensor([amount]))[0]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.negacyclic_polymul(
        torch.from_numpy(mono), torch.from_numpy(poly)).numpy(), want)


# ------------------------------------------------------------ refusals

def test_orientations_are_the_jax_lists():
    assert set(ORIENTATIONS) == {"fused", "fused_otf", "matmul", "keys_rhs",
                                 "keys_lhs", "keys_lhs_bf16"}


@pytest.mark.parametrize("orientation", CONV_ORIENTATIONS)
def test_prepare_refuses_what_the_layout_cannot_hold(keys, orientation):
    """b = 8 (a negated digit of −128 has no int8 form; JAX asserts) and
    a dropped limb (JAX ignores ``bsk_limbs`` here) raise ValueError."""
    from dataclasses import replace
    wide = replace(keys[1], params=replace(keys[1].params, bsk_base_log=8))
    with pytest.raises(ValueError, match="up to bsk_base_log 7, not 8"):
        prepare_fast_keys(wide, orientation)
    with pytest.raises(AssertionError, match="base_log 8 > 7"):
        jprep(J.TFHEKeys(params=J.TFHEParams(**vars(wide.params)),
                         lwe_key=None, glwe_key=None, bsk=keys[0].bsk,
                         ksk=keys[0].ksk), orientation)
    with pytest.raises(ValueError, match="keeps all 4 key limbs"):
        prepare_fast_keys(keys[1], orientation, bsk_limbs=3)


def test_bf16_exactness_bound():
    """keys_lhs_bf16 is exact while rows·N·8·128 < 2^24: the conv anchor
    (rows·N = 4,608) and Kreyvium-1152's fam1 (8,192) hold, rows·N =
    16,384 does not; the int8 layouts have no such bound."""
    from dataclasses import replace
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    fam1 = STAGED_PRESETS["kreyvium_p10_staged"].fam1
    for params in (bench.CONV_ANCHOR, fam1):
        assert conv_unsupported(params, "keys_lhs_bf16") is None
    wide = replace(fam1, bsk_level=8)
    assert "reaches 2^24" in conv_unsupported(wide, "keys_lhs_bf16")
    assert conv_unsupported(wide, "keys_lhs") is None


@pytest.fixture()
def full_adder_blif(tmp_path):
    from tfhe_fbs_map_tpu.frontend.circuits import build_bench
    path = tmp_path / "fa.blif"
    with open(path, "w") as f:
        build_bench("full_adder").to_blif(f, model_name="fa")
    return str(path)


def test_cli_refuses_base_8(full_adder_blif, tmp_path, capsys):
    """Keys at b = 8 through a conv orientation: exit 2 before any fast
    key is built, where the JAX CLI's ``prepare_fast_keys`` asserts."""
    from dataclasses import replace
    params = replace(T.TEST_PARAMS, bsk_base_log=8, bsk_level=2)
    path = str(tmp_path / "b8.npz")
    save_keys(path, T.generate_keys(params, seed=1, device="cpu"))
    for orientation in CONV_ORIENTATIONS:
        assert cli_main([full_adder_blif, "--map", "--keys", path,
                         "--device", "cpu", "--orientation",
                         orientation]) == 2
        out = capsys.readouterr()
        assert "up to bsk_base_log 7, not 8" in out.err and not out.out


@pytest.mark.parametrize("argv,why", [
    (["--bsk-limbs", "3"], "keeps all 4 key limbs"),
    (["--preset", "p8"], "up to bsk_base_log 7, not 8"),
    (["--preset", "p32"], "staged p32 lookup"),
])
def test_bench_refusals(argv, why, capsys):
    """The bench exits 2 before building keys: a dropped limb (JAX drops
    the flag), b = 8 (JAX asserts), the staged lookup (K1's alone)."""
    assert bench.main(["--device", "cpu", "--orientation", "keys_lhs",
                       *argv]) == 2
    out = capsys.readouterr()
    assert why in out.err and not out.out


@pytest.mark.parametrize("staged,args,why", [
    (False, ["--map", "--test-params", "--mesh", "1,2"],
     "tp=2 is not supported by --orientation keys_lhs"),
    (True, ["--params", "staged_test", "--mesh", "2"],
     "--orientation keys_lhs runs staged on one device"),
])
def test_cli_refuses_tp_and_a_staged_mesh(full_adder_blif, tmp_path, capsys,
                                          staged, args, why):
    """tp = 2 (JAX leaves tp unmapped) and a staged run under a mesh (JAX
    asserts the fused orientations) exit 2."""
    path = full_adder_blif
    if staged:
        from test_staged_executor import build_mixed_program
        prog = build_mixed_program(np.random.default_rng(2))
        prog.fbs_size = 32
        path = str(tmp_path / "mixed.lbf")
        with open(path, "w") as f:
            prog.write_lbf(f)
    assert cli_main([path, "--device", "cpu", "--batch", "2",
                     "--orientation", "keys_lhs", *args]) == 2
    out = capsys.readouterr()
    assert why in out.err and not out.out


def test_executor_refuses_a_staged_conv_mesh():
    from test_staged_executor import build_mixed_program
    from tfhe_fbs_map_tpu_torch.parallel import make_mesh
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
    preset = STAGED_PRESETS["staged_test"]
    skeys = generate_staged_keys(32, preset.fam1, preset.fam2, seed=1,
                                 device="cpu")
    pair = tuple(prepare_fast_keys(k, "keys_rhs")
                 for k in (skeys.keys1, skeys.keys2))
    with pytest.raises(ValueError, match="not keys_rhs"):
        CircuitExecutor(build_mixed_program(np.random.default_rng(2)), skeys,
                        fast_keys=pair, mesh=make_mesh(["cpu"] * 2))


def test_auto_picks_no_conv_orientation(full_adder_blif, capsys):
    """``--orientation auto`` is what it was: on CUDA K2 or K1 by
    ``pick_kernel`` for one family, K1 for both staged families; generic
    on the CPU, which the CLI's JSON names."""
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, STAGED_PRESETS
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for free in (12 << 30, 79 << 30):
        for name, (params, _) in PRESETS.items():
            want = pick_kernel(params, free)
            assert want in ("fused", "fused_otf"), name
            if name == "test":
                continue
            assert pick_orientations([params], cuda, free) == [want], name
            assert bench.bench_orientation(params, "auto", 4, cuda,
                                           free) == want
        for preset in STAGED_PRESETS.values():
            fams = [preset.fam1, preset.fam2]
            assert pick_orientations(fams, cuda, free) == ["fused_otf"] * 2
    assert pick_orientations([PRESETS["anchor"][0]], cpu) == ["generic"]
    assert cli_main([full_adder_blif, "--map", "--batch", "2", "--device",
                     "cpu", "--test-params"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["orientation"] == "generic" and res["bit_exact"]
