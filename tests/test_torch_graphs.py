"""Scan-grouped execution of the PyTorch port against the JAX executor's
scanned ``run``: the level groups (``_scan_groups_from(0)``), the final wire
buffer of a run without a checkpoint (bitwise) through every bootstrap path
of both pipelines, and the level-by-level walk with a checkpoint.  On the
CPU each group's levels run one ``step`` after another; the CUDA graph
replay of a group is held to that in ``tests/test_torch_gpu.py``."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
import tfhe_fbs_map_tpu.tfhe.staged as JS
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu.frontend import BasicMapper
from tfhe_fbs_map_tpu.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
from tfhe_fbs_map_tpu.runtime import executor as jexec
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.runtime import executor as texec
from test_staged_executor import build_mixed_program
from test_torch_executor import carried as carried_native
from test_torch_executor import mapped as mapped_native
from test_torch_executor import plan_arrays
from test_torch_staged import FAMILIES, tp
from test_torch_staged import carried as carried_staged
from test_torch_staged import mapped as mapped_staged
from test_torch_staged_executor import jax_staged_executor

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AES_LBF = ROOT / "outputs" / "bristol" / "aes_128_4_search.lbf"
KREYVIUM_LBF = ROOT / "outputs" / "generated" \
    / "kreyvium_stream_v1_10_search.lbf"


def jax_groups(jex) -> list[tuple]:
    """(n_splits or None, levels) of each JAX scan group, in order."""
    return [(ns, n) for ns, _, n in jex._scan_groups_from(0)]


def port_groups(levels, staged: bool) -> list[tuple]:
    """The same of the port's :func:`level_groups`, which must cover the
    levels in order."""
    groups = texec.level_groups(levels, staged)
    assert [g.start for g in groups] == [0] + [g.stop for g in groups[:-1]]
    assert groups[-1].stop == len(levels)
    return [(levels[g.start].n_splits if staged else None, len(g))
            for g in groups]


def shell(params):
    return jexec.TFHEKeys(params=params, lwe_key=None, glwe_key=None,
                          bsk=None, ksk=None)


@pytest.mark.parametrize("name", ["aes_128", "full_adder", "aes_sbox"])
def test_native_groups_equal_jax(name):
    """Native plans at the test parameters: the same groups as JAX's, in
    count, order and length.  AES-128 falls into 49."""
    prog = (parse_lbf(AES_LBF.read_text()) if name == "aes_128"
            else mapped_native(name))
    jex = jexec.CircuitExecutor(prog, shell(J.TEST_PARAMS))
    want = jax_groups(jex)
    assert port_groups(texec.compile_program(prog, T.TEST_PARAMS).levels,
                       False) == want
    if name == "aes_128":
        assert len(want) == 49 and sum(n for _, n in want) == 230


@pytest.mark.parametrize("name,p", [("mixed", 32), ("kreyvium_1152", 10),
                                    ("kreyvium_iter_v1", 10)])
def test_staged_groups_equal_jax(name, p):
    """Staged plans: the same groups as JAX's, keyed by ``n_splits`` too.
    Kreyvium-1152 falls into 4 (1, 22, 1 and 1 levels)."""
    if name == "mixed":
        prog = build_mixed_program(np.random.default_rng(2))
    elif name == "kreyvium_1152":
        prog = parse_lbf(KREYVIUM_LBF.read_text())
    else:
        prog = mapped_staged(name, p)
    jex = jax_staged_executor(prog, p)
    f1, f2 = FAMILIES[p]
    levels = texec.compile_staged(prog, p, tp(f1), tp(f2)).levels
    want = jax_groups(jex)
    assert port_groups(levels, True) == want
    if name == "kreyvium_1152":
        assert [n for _, n in want] == [1, 22, 1, 1]


# The JAX package holds its kernels bitwise equal to each other and to its
# generic bootstrap (tests/test_fast_path.py), so one scanned JAX run a
# program through generic and one through K2 ("fused") stand for its three
# paths: K1's interpret-mode Pallas inside a scan is the costliest compile
# here.  The staged program's scanned JAX run is its generic one.
JAX_PATH = {"generic": "generic", "fused": "fused", "fused_otf": "fused"}


@pytest.fixture(scope="module")
def native_keys():
    """JAX keys at the test parameters, carried into the port, the fast
    keys of each path JAX and the port run, and a cache of JAX's scanned
    runs, made once."""
    jk = J.generate_keys(J.TEST_PARAMS, seed=7)
    tk = carried_native(jk)
    jfast = {"generic": None, "fused": jprep(jk, orientation="fused")}
    tfast = {"generic": None, **{o: prepare_fast_keys(tk, o)
                                 for o in ("fused", "fused_otf")}}
    return jk, tk, jfast, tfast, {}


def scanned(cache: dict, key, jex, vals) -> np.ndarray:
    """JAX's ``run`` of ``jex`` on ``vals`` (encrypted from
    ``default_rng(1)``), which takes its ``lax.scan`` path; once a key."""
    if key not in cache:
        buf = jex.run(jex.encrypt_inputs(vals, np.random.default_rng(1)))
        assert jex._local_scan is not None
        cache[key] = np.asarray(buf)
    return cache[key]


@pytest.mark.parametrize("name", ["full_adder", "aes_sbox"])
@pytest.mark.parametrize("orientation", ["generic", "fused", "fused_otf"])
def test_native_run_equals_jax_scanned_run(native_keys, name, orientation):
    """JAX's scanned ``run`` and the port's grouped ``run`` on the same keys
    and inputs: the final wire buffers bitwise equal."""
    jk, tk, jfast, tfast, cache = native_keys
    prog = mapped_native(name)
    jpath = JAX_PATH[orientation]
    jex = jexec.CircuitExecutor(prog, jk, fast_keys=jfast[jpath])
    tex = texec.CircuitExecutor(prog, tk, fast_keys=tfast[orientation])
    assert len(tex.groups) < len(tex.levels) or name == "full_adder"
    rng = np.random.default_rng(7)
    vals = {n.name: rng.integers(0, 2, 2)
            for n in prog.nodes if n.kind == "input"}
    want = scanned(cache, (name, jpath), jex, vals)
    tbuf0 = tex.encrypt_inputs(vals, np.random.default_rng(1))
    tbuf = tex.run(tbuf0)
    assert tex.capture(tbuf0) == 0              # no graph on the CPU
    assert np.array_equal(want, tbuf.numpy())
    got = tex.decrypt_outputs(tbuf)
    for k, w in prog.eval(vals).items():
        assert np.array_equal(np.asarray(w), got[k]), k


@pytest.fixture(scope="module")
def staged_keys():
    """JAX staged keys at the p=32 test families, the port's copy, and a
    cache of JAX's scanned runs."""
    jsk = JS.generate_staged_keys(32, *FAMILIES[32], seed=13)
    return jsk, carried_staged(jsk), {}


@pytest.mark.parametrize("orientation", ["generic", "fused_otf"])
def test_staged_run_equals_jax_scanned_run(staged_keys, orientation):
    """The p=32 program with every staged route, through the generic
    bootstrap and through K1's plain version in both families."""
    prog = build_mixed_program(np.random.default_rng(2))
    jsk, tsk, cache = staged_keys
    tfast = None
    if orientation != "generic":
        tfast = tuple(prepare_fast_keys(k, orientation=orientation)
                      for k in (tsk.keys1, tsk.keys2))
    jex = jax_staged_executor(prog, 32, jsk)
    tex = texec.CircuitExecutor(prog, tsk, fast_keys=tfast)
    rng = np.random.default_rng(0)
    vals = {n.name: rng.integers(0, 2, 3)
            for n in prog.nodes if n.kind == "input"}
    want = scanned(cache, "mixed", jex, vals)
    tbuf = tex.run(tex.encrypt_inputs(vals, np.random.default_rng(1)))
    assert np.array_equal(want, tbuf.numpy())
    got = tex.decrypt_outputs(tbuf)
    for k, w in prog.eval(vals).items():
        assert np.array_equal(got[k] % 64, np.asarray(w) % 64), k


def steps_taken(monkeypatch, tex) -> list[int]:
    """Record the level of every ``step`` call of ``tex``."""
    taken = []
    inner = tex.step

    def step(buf, lv):
        taken.append(lv)
        return inner(buf, lv)
    monkeypatch.setattr(tex, "step", step)
    return taken


def test_run_walks_groups_and_a_checkpoint_walks_levels(native_keys,
                                                        tmp_path,
                                                        monkeypatch):
    """Without a checkpoint ``run`` steps through each group's levels in
    order; with one it steps level by level, and resumes from a JAX
    snapshot taken inside a group at the level after it, bitwise equal to
    JAX's scanned run."""
    prog = mapped_native("full_adder", BasicMapper())
    jk, tk, *_ = native_keys
    jex = jexec.CircuitExecutor(prog, jk)
    tex = texec.CircuitExecutor(prog, tk)
    assert [len(g) for g in tex.groups] == [2, 1]
    rng = np.random.default_rng(4)
    vals = {n.name: rng.integers(0, 2, 4)
            for n in prog.nodes if n.kind == "input"}
    jbuf0 = jex.encrypt_inputs(vals, rng)
    jfull = np.asarray(jex.run(jbuf0))
    taken = steps_taken(monkeypatch, tex)
    whole = tex.run(torch.from_numpy(np.array(jbuf0)))
    assert taken == list(range(len(tex.levels)))
    assert np.array_equal(jfull, whole.numpy())

    # JAX's snapshot after level 0, in the format its run writes
    jbuf1 = jexec._level_step(jk, None, jbuf0, *map(
        jnp.asarray, plan_arrays(jex.levels[0])))
    ckpt = str(tmp_path / "jax.npz")
    np.savez(ckpt, buf=np.asarray(jbuf1), level=0,
             num_levels=len(jex.levels))
    taken.clear()
    resumed = tex.run(torch.from_numpy(np.array(jbuf0)), checkpoint=ckpt,
                      checkpoint_every=1)
    assert taken == [1, 2]
    assert np.array_equal(jfull, resumed.numpy())


def test_new_levels_drop_plans_and_graphs():
    """Replacing ``levels`` (as the calibration does) drops the plan
    tensors and graphs built from the old ones."""
    prog = mapped_native("full_adder")
    tex = texec.CircuitExecutor(prog, T.generate_keys(T.TEST_PARAMS, seed=0,
                                                      device="cpu"))
    tex.plan_tensors()
    tex._graphs["stale"] = None
    tex.levels = tex.levels[:1]
    assert tex._plan_device is None and tex._graphs == {}
    assert len(tex.plan_tensors()) == 1 and len(tex.groups) == 1
