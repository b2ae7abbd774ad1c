"""The staged executor of the PyTorch port against the JAX package: the
staged plan compiler and probe (arrays equal), the wire buffer after every
level (bitwise), decryptions against the cleartext oracle, the refusal of
unsplittable programs and the resumption of a JAX staged checkpoint."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe.staged as JS
from tfhe_fbs_map_tpu.frontend.lut_program import LutProgram
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
from tfhe_fbs_map_tpu.runtime import executor as jexec
import tfhe_fbs_map_tpu_torch.tfhe.staged as TS
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.runtime import executor as texec
from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
from test_staged_executor import P32_F1, P32_F2, build_mixed_program
from test_torch_staged import FAMILIES, carried, mapped, tp

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

KREYVIUM_LBF = Path(__file__).resolve().parents[1] / "outputs" \
    / "generated" / "kreyvium_stream_v1_10_search.lbf"


# ------------------------------------------------------------- compile

def jax_staged_executor(prog, p, jkeys=None, fast=None):
    """The JAX staged executor, with key shells where no keys are given
    (its compile touches no key material)."""
    if jkeys is None:
        f1, f2 = FAMILIES[p]

        def shell(params):
            return jexec.TFHEKeys(params=params, lwe_key=None,
                                  glwe_key=None, bsk=None, ksk=None)
        jkeys = JS.StagedKeys(p=p, keys1=shell(f1), keys2=shell(f2))
    return jexec.CircuitExecutor(prog, jkeys, fast_keys=fast)


def assert_same_plan(got, want):
    assert len(got.levels) == len(want.levels)
    assert (got.num_bootstraps, got.dummy_row, got.num_wires) == (
        want.num_bootstraps, want.dummy_row, want.num_wires)
    assert got.input_rows == want.input_rows
    for lg, lw in zip(got.levels, want.levels):
        assert lg.n_splits == lw.n_splits
        for a, b in zip(lg.arrays(), jexec_arrays(lw)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got.row_scale, want.row_scale)
    assert got.row_scale.dtype == want.row_scale.dtype
    assert got.route_counts == want.route_counts
    assert (got.eff_norm1, got.eff_norm2) == (want.eff_norm1,
                                              want.eff_norm2)
    assert got.level_routes == want.level_routes
    routes = got.route_counts
    assert routes["f1"] + routes["f2"] + 2 * routes["split"] \
        == want.num_stage_calls
    assert got.outputs.keys() == want.outputs.keys()
    for k, spec in want.outputs.items():
        g = got.outputs[k]
        assert (g.kind, g.const) == (spec.kind, spec.const)
        assert np.array_equal(g.wire_idx, spec.wire_idx)
        assert np.array_equal(g.coefs, spec.coefs)


def jexec_arrays(lv):
    return (lv.wire_idx1, lv.coefs1, lv.consts1, lv.tvs1, lv.posts1,
            lv.out_rows1, lv.wire_idx2, lv.coefs2, lv.consts2, lv.tvs2,
            lv.posts2, lv.out_rows)


@pytest.mark.parametrize("name,p", [("mixed", 32), ("aes_sbox", 16),
                                    ("kreyvium_iter_v1", 10)])
def test_compile_staged_equals_jax(name, p):
    prog = (build_mixed_program(np.random.default_rng(2)) if name == "mixed"
            else mapped(name, p))
    want = jax_staged_executor(prog, p)
    f1, f2 = FAMILIES[p]
    got = texec.compile_staged(prog, p, tp(f1), tp(f2))
    assert_same_plan(got, want)
    if name == "mixed":
        assert got.route_counts == {"f1": 1, "f2": 1, "split": 2}


def test_staged_probe_on_kreyvium_1152():
    from tfhe_fbs_map_tpu.frontend.lut_program import parse_lbf as jparse
    prog = parse_lbf(KREYVIUM_LBF.read_text())
    assert texec.staged_probe(prog, 10) == (
        27, 25, {"f1": 8754, "f2": 93, "split": 0})
    routes = texec.staged_level_routes(prog, 10)
    assert routes == jexec.staged_level_routes(
        jparse(KREYVIUM_LBF.read_text()), 10)
    # one fam1 call a level, a fam2 call on three: 28 launches a run
    assert len(routes) == 25
    assert sum(bool(s + f1) + bool(s + f2) for s, f1, f2 in routes) == 28


def test_rejects_unsplittable():
    prog = LutProgram()
    w = [prog.input(f"w{i}") for i in range(20)]
    t = list(np.random.default_rng(0).integers(0, 2, 21))
    t[0] = 0
    prog.output("o", prog.bootstrap(prog.linear([1] * 20, w, 0), t))
    with pytest.raises(ValueError, match="staged pipeline cannot realize"):
        texec.compile_staged(prog, 32, tp(P32_F1), tp(P32_F2))
    with pytest.raises(ValueError, match="staged pipeline cannot realize"):
        texec.staged_probe(prog, 32)


# ------------------------------------------------------------- executor

@pytest.mark.parametrize("name,p,orients,vectors", [
    ("mixed", 32, ("fused_otf", "fused"), 4),
    ("mixed", 32, (None, None), 3),
    ("kreyvium_iter_v1", 10, (None, None), 2),
    ("mixed", 32, ("keys_lhs", "keys_rhs"), 3),
    ("mixed", 32, ("keys_lhs_bf16", "keys_lhs_bf16"), 2),
])
def test_wire_buffer_equal_after_every_level(name, p, orients, vectors):
    """Same keys (carried across), same rng: the buffer after encryption
    and after each staged level step is bitwise equal to the JAX
    executor's, and the decryptions equal JAX's and the oracle's."""
    prog = (build_mixed_program(np.random.default_rng(2)) if name == "mixed"
            else mapped(name, p))
    f1, f2 = FAMILIES[p]
    jsk = JS.generate_staged_keys(p, f1, f2, seed=13)
    tsk = carried(jsk)
    jfast = tfast = None
    if orients[0] is not None:
        jfast = tuple(jprep(k, orientation=o)
                      for k, o in zip((jsk.keys1, jsk.keys2), orients))
        tfast = tuple(prepare_fast_keys(k, orientation=o)
                      for k, o in zip((tsk.keys1, tsk.keys2), orients))
    jex = jax_staged_executor(prog, p, jsk, jfast)
    tex = texec.CircuitExecutor(prog, tsk, fast_keys=tfast)
    assert tex.staged and len(tex.levels) == len(jex.levels) >= 1

    rng = np.random.default_rng(0)
    vals = {n.name: rng.integers(0, 2, vectors)
            for n in prog.nodes if n.kind == "input"}
    jbuf = jex.encrypt_inputs(vals, np.random.default_rng(1))
    tbuf = tex.encrypt_inputs(vals, np.random.default_rng(1))
    assert np.array_equal(np.asarray(jbuf), tbuf.numpy())
    jf1, jf2 = jfast or (None, None)
    for lv, plan in enumerate(jex.levels):
        jbuf = jexec._staged_level_step(
            jsk.keys1, jsk.keys2, jf1, jf2, plan.n_splits, jbuf,
            *map(jnp.asarray, jexec_arrays(plan)))
        tbuf = tex.step(tbuf, lv)
        assert np.array_equal(np.asarray(jbuf), tbuf.numpy()), lv
    want, got = jex.decrypt_outputs(jbuf), tex.decrypt_outputs(tbuf)
    oracle = prog.eval(vals)
    for k in oracle:
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(got[k] % (2 * p),
                              np.asarray(oracle[k]) % (2 * p)), k


def test_mapped_circuit_decrypts_like_oracle():
    """aes_sbox mapped at p=16: every node routes as a fam1 or fam2
    single (test_staged_executor's mapped-circuit case)."""
    prog = mapped("aes_sbox", 16)
    tsk = TS.generate_staged_keys(16, tp(P32_F1), tp(P32_F2), seed=11,
                                  device="cpu")
    ex = texec.CircuitExecutor(prog, tsk)
    assert ex.plan.route_counts["split"] == 0
    rng = np.random.default_rng(7)
    values = {n.name: rng.integers(0, 2, 4)
              for n in prog.nodes if n.kind == "input"}
    got = ex.run_cleartext(values, seed=8)
    for k, want in prog.eval(values).items():
        assert np.array_equal(got[k] % 32, np.asarray(want) % 32), k


def test_jax_staged_checkpoint_resumes_in_port(tmp_path):
    prog = build_mixed_program(np.random.default_rng(3))
    jsk = JS.generate_staged_keys(32, P32_F1, P32_F2, seed=4)
    jex = jax_staged_executor(prog, 32, jsk)
    rng = np.random.default_rng(4)
    vals = {n.name: rng.integers(0, 2, 2)
            for n in prog.nodes if n.kind == "input"}
    jbuf0 = jex.encrypt_inputs(vals, rng)
    ckpt = str(tmp_path / "jax.npz")
    jfull = jex.run(jbuf0, checkpoint=ckpt, checkpoint_every=1)
    with np.load(ckpt) as z:
        assert 0 <= int(z["level"]) < len(jex.levels) - 1
    tex = texec.CircuitExecutor(prog, carried(jsk))
    tfull = tex.run(torch.from_numpy(np.array(jbuf0)), checkpoint=ckpt)
    assert np.array_equal(np.asarray(jfull), tfull.numpy())
    want, got = jex.decrypt_outputs(jfull), tex.decrypt_outputs(tfull)
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_staged_test_preset_is_the_test_families():
    preset = STAGED_PRESETS["staged_test"]
    assert preset.p == 32 and preset.p_error is None
    assert vars(preset.fam1) == vars(P32_F1)
    assert vars(preset.fam2) == vars(P32_F2)


def test_executor_takes_a_pair_of_fast_keys():
    prog = build_mixed_program(np.random.default_rng(2))
    tsk = TS.generate_staged_keys(32, tp(P32_F1), tp(P32_F2), device="cpu")
    fast = prepare_fast_keys(tsk.keys1, orientation="fused_otf")
    with pytest.raises(ValueError, match="pair"):
        texec.CircuitExecutor(prog, tsk, fast_keys=(fast,))
