"""Executor of the PyTorch port against the JAX CircuitExecutor: the plan
compiler, the wire buffer after every level (bitwise), decryptions against
the cleartext oracle, and checkpoint resume."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.frontend import BasicMapper, HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
from tfhe_fbs_map_tpu.runtime import executor as jexec
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.runtime import executor as texec
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

P = T.TEST_PARAMS
AES_LBF = Path(__file__).resolve().parents[1] / "outputs" / "bristol" \
    / "aes_128_4_search.lbf"


def mapped(name, mapper=None):
    prog = (mapper or HeuristicMapper(cone_merger="search", fbs_size=4)) \
        .map(build_bench(name))
    prog.remove_dangling_nodes()
    return prog


def carried(jk):
    return T.keys_from_numpy(T.TFHEParams(**vars(jk.params)),
                             np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
                             np.asarray(jk.bsk), np.asarray(jk.ksk),
                             device="cpu")


@pytest.fixture(scope="module")
def tkeys():
    return T.generate_keys(P, seed=11, device="cpu")


def plan_arrays(plan):
    return (plan.wire_idx, plan.coefs, plan.consts, plan.test_polys,
            plan.posts, plan.out_rows)


def test_plan_compiler_equals_jax_on_aes128():
    prog = parse_lbf(open(AES_LBF).read())
    params = PRESETS["aes128_p4"][0]
    shell = jexec.TFHEKeys(params=J.TFHEParams(**vars(params)), lwe_key=None,
                           glwe_key=None, bsk=None, ksk=None)
    want = jexec.CircuitExecutor(prog, shell)
    got = texec.compile_program(prog, params)
    assert len(got.levels) == len(want.levels) == 230
    assert got.num_bootstraps == want.num_bootstraps == 20759
    assert (got.dummy_row, got.num_wires) == (want.dummy_row,
                                              want.num_wires)
    assert got.input_rows == want.input_rows
    for lw, lg in zip(want.levels, got.levels):
        for a, b in zip(plan_arrays(lw), plan_arrays(lg)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want.outputs.keys() == got.outputs.keys()
    for k, spec in want.outputs.items():
        g = got.outputs[k]
        assert (spec.kind, spec.const) == (g.kind, g.const)
        assert np.array_equal(spec.wire_idx, g.wire_idx)
        assert np.array_equal(spec.coefs, g.coefs)


def test_wire_buffer_equal_after_every_level():
    """Same keys (carried across), fused_otf on both sides, same rng: the
    buffer after encryption and after each level step is bitwise equal.
    The basic mapping has several levels and padded ones (dummy row)."""
    prog = mapped("full_adder", BasicMapper())
    jk = J.generate_keys(J.TEST_PARAMS, seed=5)
    tk = carried(jk)
    jfast = jprep(jk, orientation="fused_otf")
    tfast = prepare_fast_keys(tk, orientation="fused_otf")
    jex = jexec.CircuitExecutor(prog, jk, fast_keys=jfast)
    tex = texec.CircuitExecutor(prog, tk, fast_keys=tfast)
    assert len(tex.levels) == len(jex.levels) >= 2

    vals = {n.name: np.random.default_rng(0).integers(0, 2, 3)
            for n in prog.nodes if n.kind == "input"}
    jbuf = jex.encrypt_inputs(vals, np.random.default_rng(1))
    tbuf = tex.encrypt_inputs(vals, np.random.default_rng(1))
    assert np.array_equal(np.asarray(jbuf), tbuf.numpy())
    tplans = tex.plan_tensors()
    for lv, plan in enumerate(jex.levels):
        jbuf = jexec._level_step(jk, jfast, jbuf,
                                 *map(jnp.asarray, plan_arrays(plan)))
        tbuf = texec._level_step(tk, tfast, tbuf, *tplans[lv])
        assert np.array_equal(np.asarray(jbuf), tbuf.numpy()), lv
    want = jex.decrypt_outputs(jbuf)
    got = tex.decrypt_outputs(tbuf)
    for k in want:
        assert np.array_equal(want[k], got[k]), k


def run_both(prog, keys, n_vectors, seed=3, fast=None):
    rng = np.random.default_rng(seed)
    vals = {n.name: rng.integers(0, 2, n_vectors)
            for n in prog.nodes if n.kind == "input"}
    oracle = prog.eval(vals)
    ex = texec.CircuitExecutor(prog, keys, fast_keys=fast)
    got = ex.run_cleartext(vals, seed=seed + 1)
    for k in oracle:
        assert np.array_equal(np.asarray(oracle[k]), got[k]), k
    return ex


@pytest.mark.parametrize("name,mapper,n_vectors", [
    ("full_adder", None, 8),
    ("full_adder", BasicMapper(), 8),
    ("ascon_lut", None, 4),
])
def test_decryptions_equal_oracle(tkeys, name, mapper, n_vectors):
    ex = run_both(mapped(name, mapper), tkeys, n_vectors)
    assert ex.num_bootstraps >= 1 and len(ex.levels) >= 1


def test_fused_path_decrypts_like_oracle(tkeys):
    fast = prepare_fast_keys(tkeys, orientation="fused")
    run_both(mapped("full_adder"), tkeys, 4, fast=fast)


def test_checkpoint_resume(tmp_path, tkeys):
    """An interrupted run resumes from its last level snapshot bit-exactly,
    in a fresh executor."""
    prog = mapped("ascon_lut")
    ex = texec.CircuitExecutor(prog, tkeys)
    assert len(ex.levels) >= 2
    rng = np.random.default_rng(0)
    vals = {n.name: rng.integers(0, 2, 4)
            for n in prog.nodes if n.kind == "input"}
    buf0 = ex.encrypt_inputs(vals, rng)
    full = ex.run(buf0)
    want = ex.decrypt_outputs(full)

    ckpt = str(tmp_path / "run.npz")
    ex.run(buf0, checkpoint=ckpt, checkpoint_every=1)
    with np.load(ckpt) as z:
        assert set(z.files) == {"buf", "level", "num_levels"}
        assert int(z["level"]) == len(ex.levels) - 2
    ex2 = texec.CircuitExecutor(prog, tkeys)
    resumed = ex2.run(buf0, checkpoint=ckpt, checkpoint_every=1)
    assert torch.equal(resumed, full)
    got = ex2.decrypt_outputs(resumed)
    assert all(np.array_equal(want[k], got[k]) for k in want)


def test_jax_snapshot_resumes_in_port(tmp_path):
    prog = mapped("full_adder", BasicMapper())
    jk = J.generate_keys(J.TEST_PARAMS, seed=2)
    tk = carried(jk)
    jex = jexec.CircuitExecutor(prog, jk)
    rng = np.random.default_rng(4)
    vals = {n.name: rng.integers(0, 2, 4)
            for n in prog.nodes if n.kind == "input"}
    jbuf0 = jex.encrypt_inputs(vals, rng)
    ckpt = str(tmp_path / "jax.npz")
    jfull = jex.run(jbuf0, checkpoint=ckpt, checkpoint_every=1)
    tex = texec.CircuitExecutor(prog, tk)
    tfull = tex.run(torch.from_numpy(np.array(jbuf0)), checkpoint=ckpt)
    assert np.array_equal(np.asarray(jfull), tfull.numpy())


def test_adaptive_checkpoint_budget(tmp_path, tkeys):
    prog = mapped("full_adder", BasicMapper())
    ex = texec.CircuitExecutor(prog, tkeys)
    rng = np.random.default_rng(0)
    vals = {n.name: rng.integers(0, 2, 4)
            for n in prog.nodes if n.kind == "input"}
    buf = ex.encrypt_inputs(vals, rng)
    never = tmp_path / "never.npz"
    ex.run(buf, checkpoint=str(never), checkpoint_budget=0.0)
    assert not never.exists()
    always = tmp_path / "always.npz"
    ex.run(buf, checkpoint=str(always), checkpoint_budget=1e9)
    assert always.exists()


def test_refuses_mesh_and_staged_keys(tkeys):
    """Both pipelines take a dp mesh (``test_torch_parallel.py``) and refuse
    anything else as one; staged keys are taken (``test_torch_staged_
    executor.py``), keys of no family are not."""
    from tfhe_fbs_map_tpu_torch.parallel import make_mesh
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
    prog = mapped("full_adder")
    preset = STAGED_PRESETS["staged_test"]
    skeys = generate_staged_keys(preset.p, preset.fam1, preset.fam2,
                                 device="cpu")
    mesh = make_mesh(["cpu"] * 2)
    for keys in (tkeys, skeys):
        with pytest.raises(TypeError, match="Mesh"):
            texec.CircuitExecutor(prog, keys, mesh=object())
        assert texec.CircuitExecutor(prog, keys, mesh=mesh).mesh is mesh
    assert texec.CircuitExecutor(prog, skeys).staged
    with pytest.raises(TypeError):
        texec.CircuitExecutor(prog, object())
