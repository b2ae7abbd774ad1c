"""The port's dp mesh (``tfhe_fbs_map_tpu_torch.parallel``) on the CPU,
against one device and against the JAX package's mesh code on the
conftest's 8 virtual devices: sharded FBS, the mesh executor on the full
adder (final wire buffers bitwise), checkpoint resume across dp, the dry
run, the multi-chip bench and the refusals.  aes_sbox and the staged p=32
program are in ``test_torch_parallel_programs.py``."""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.frontend import HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.ops.blind_rotate import prepare_fast_keys as jprep
from tfhe_fbs_map_tpu.parallel import mesh as jmesh
from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor as JExecutor
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch import bench_multichip
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    FastKeys, functional_bootstrap_fast, prepare_fast_keys)
from tfhe_fbs_map_tpu_torch.parallel import (distributed, dryrun,
                                             global_mesh, init_distributed,
                                             make_mesh, replicate,
                                             shard_batch, shard_fast_keys,
                                             sharded_bootstrap)
from tfhe_fbs_map_tpu_torch.parallel.distributed import gather_outputs
from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
from tfhe_fbs_map_tpu_torch.tfhe.keys import keys_from_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import __graft_entry__ as G  # noqa: E402

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(dp):
    return make_mesh(["cpu"] * dp)


def key_arrays(jk):
    return (T.TFHEParams(**vars(jk.params)), np.asarray(jk.lwe_key),
            np.asarray(jk.glwe_key), np.asarray(jk.bsk), np.asarray(jk.ksk))


def carried(jk):
    return keys_from_numpy(*key_arrays(jk), device="cpu")


def to_port(jprog):
    """A JAX-built program written out and read back by the port."""
    out = io.StringIO()
    jprog.write_lbf(out)
    return parse_lbf(out.getvalue())


def mapped(name):
    circ = build_bench(name)
    prog = HeuristicMapper(cone_merger="search",
                           fbs_size=J.TEST_PARAMS.p).map(circ)
    prog.remove_dangling_nodes()
    return circ, prog


# ------------------------------------------------------------------ mesh

def test_public_names_equal_jax():
    import tfhe_fbs_map_tpu.parallel as jparallel
    import tfhe_fbs_map_tpu_torch.parallel as tparallel
    assert sorted(tparallel.__all__) == sorted(jparallel.__all__)
    assert all(hasattr(tparallel, n) for n in tparallel.__all__)


def test_mesh_shape_positions_and_refusals(monkeypatch):
    mesh = make_mesh(["cpu"] * 3)
    assert mesh.shape == {"dp": 3, "tp": 1} and mesh.dp == 3
    assert mesh.distinct == [CPU] and not mesh.spans_processes
    with pytest.raises(ValueError, match="cannot form mesh"):
        make_mesh(["cpu"] * 3, dp=4)
    # tp > 1 is a mesh of matmul positions (test_torch_tp.py); tp=0 none,
    # and a tp that does not divide a process's positions is refused
    assert make_mesh(["cpu"] * 2, tp=2).shape == {"dp": 1, "tp": 2}
    with pytest.raises(ValueError, match="at least one position"):
        make_mesh(["cpu"] * 2, tp=0)
    for tp in (2, 0):
        with pytest.raises(ValueError, match="must divide the 1 local"):
            global_mesh(tp=tp, devices=["cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert make_mesh().devices == (torch.device("cuda", 0),
                                   torch.device("cuda", 1))
    # positions dealt round-robin: two shards a card
    assert [d.index for d in make_mesh(dp=4).devices] == [0, 1, 0, 1]


@pytest.mark.parametrize("gpus,local,want", [
    (4, None, [[0, 1, 2, 3]]),            # no torchrun: every visible GPU
    (4, 4, [[0], [1], [2], [3]]),         # torchrun: one GPU a rank
    (4, 2, [[0, 2], [1, 3]]),
    (1, 2, [[0], [0]]),                   # two ranks share one card
])
def test_local_gpus_under_torchrun(monkeypatch, gpus, local, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    got = []
    for rank in range(local or 1):
        if local is None:
            monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
            monkeypatch.delenv("LOCAL_RANK", raising=False)
        else:
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
            monkeypatch.setenv("LOCAL_RANK", str(rank))
        got.append([d.index for d in distributed.local_gpus()])
    assert got == want
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.local_gpus()


def test_shard_replicate_and_keys_per_device():
    mesh = cpu_mesh(4)
    x = torch.arange(24, dtype=torch.int32).reshape(2, 12)
    shards = shard_batch(mesh, x, axis=1)
    assert [tuple(s.shape) for s in shards] == [(2, 3)] * 4
    assert torch.equal(torch.cat(shards, dim=1), x)
    shards[0][0, 0] = -1                  # a copy, not a view of x
    assert x[0, 0] == 0
    with pytest.raises(ValueError, match=r"batch 12 must be divisible by "
                                         r"the dp axis \(5\)"):
        shard_batch(cpu_mesh(5), x, axis=1)
    rep = replicate(mesh, x)
    assert len(rep) == 4 and all(r is rep[0] for r in rep)
    keys = T.generate_keys(T.TEST_PARAMS, seed=1, device="cpu")
    fast = prepare_fast_keys(keys, orientation="fused_otf")
    per = shard_fast_keys(mesh, fast)
    assert list(per) == [CPU] and per[CPU] is fast
    # .to copies the key material, never draws new keys
    assert keys.to("cpu") is keys and fast.to("cpu") is fast
    meta = keys.to("meta")
    assert meta.bsk.is_meta and meta.bsk.shape == keys.bsk.shape
    assert keys.bsk.device == CPU
    fmeta = fast.to("meta")
    assert isinstance(fmeta, FastKeys) and fmeta.bsk_kernels.is_meta
    assert fmeta.orientation == "fused_otf"


@pytest.mark.parametrize("orientation,dp", [("fused", 8), ("fused_otf", 4),
                                            ("fused_otf", 2)])
def test_sharded_bootstrap_matches_one_device_and_jax(orientation, dp):
    """The JAX dry run's tiny setup (N=64, which the plain versions serve):
    the port's sharded FBS equals its one-device FBS and JAX's
    ``sharded_bootstrap`` on the same keys and ciphertexts."""
    params, _, cts, tvs, posts = G._tiny_setup(seed=5)
    jk = J.generate_keys(params, seed=5)
    jfast = jprep(jk, orientation=orientation)
    jm = jmesh.make_mesh(jax.devices()[:dp], dp=dp, tp=1)
    jfn = jmesh.sharded_bootstrap(jm, jmesh.shard_fast_keys(jm, jfast))
    want = np.asarray(jfn(*(jmesh.shard_batch(jm, x)
                            for x in (cts, tvs, posts))))

    fast = prepare_fast_keys(carried(jk), orientation=orientation)
    args = [torch.from_numpy(np.array(x)) for x in (cts, tvs, posts)]
    one = functional_bootstrap_fast(fast, *args)
    mesh = cpu_mesh(dp)
    got = sharded_bootstrap(mesh, fast)(*(shard_batch(mesh, x)
                                          for x in args))
    assert len(got) == dp and all(g.shape[0] == 8 // dp for g in got)
    got = torch.cat(got)
    assert torch.equal(got, one)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="shards"):
        sharded_bootstrap(mesh, fast)(*(shard_batch(mesh, x)[:1]
                                        for x in args))


# ------------------------------------------------------- mesh executor

def executor_runs(jprog, jkeys, tkeys, values, orientation, dp, seed,
                  jax_fast=True):
    """The JAX mesh executor, the port's mesh executor and the port on one
    device, same keys and draws: their final wire buffers (numpy, torch
    whole, torch shards) and the port's mesh executor."""
    tprog = to_port(jprog)
    jfast = tfast = None
    if orientation is not None:
        if jax_fast:
            jfast = jprep(jkeys, orientation=orientation)
        tfast = (prepare_fast_keys(tkeys, orientation=orientation)
                 if not hasattr(tkeys, "keys1") else tuple(
                     prepare_fast_keys(k, orientation=orientation)
                     for k in (tkeys.keys1, tkeys.keys2)))
    jm = jmesh.make_mesh(jax.devices()[:dp], dp=dp, tp=1)
    jex = JExecutor(jprog, jkeys, fast_keys=jfast, mesh=jm)
    want = np.asarray(jex.run(jex.encrypt_inputs(
        values, np.random.default_rng(seed))))
    one = CircuitExecutor(tprog, tkeys, fast_keys=tfast)
    whole = one.run(one.encrypt_inputs(values, np.random.default_rng(seed)))
    ex = CircuitExecutor(tprog, tkeys, fast_keys=tfast, mesh=cpu_mesh(dp))
    shards = ex.run(ex.encrypt_inputs(values, np.random.default_rng(seed)))
    return want, whole, shards, ex


@pytest.mark.parametrize("orientation", [None, "fused", "fused_otf"])
def test_mesh_executor_full_adder(orientation):
    """dp 8, batch 16: the final wire buffer equals JAX's mesh executor's
    and the port's on one device (generic, K2's and K1's plain versions),
    and decrypts to the circuit."""
    circ, jprog = mapped("full_adder")
    jk = J.generate_keys(J.TEST_PARAMS, seed=7)
    rng = np.random.default_rng(8)
    values = {i.name: rng.integers(0, 2, 16) for i in circ.inputs}
    want, whole, shards, ex = executor_runs(jprog, jk, carried(jk), values,
                                            orientation, 8, seed=9)
    assert len(shards) == 8 and all(s.shape[1] == 2 for s in shards)
    got = torch.cat(shards, dim=1)
    assert torch.equal(got, whole)
    assert np.array_equal(got.numpy(), want)
    outs = ex.decrypt_outputs(shards)
    for k, w in circ.eval(values).items():
        assert np.array_equal(np.asarray(w), outs[k]), k


@pytest.mark.parametrize("orientation", ["keys_lhs", "keys_rhs"])
def test_mesh_executor_conv_dp2(orientation):
    """A conv orientation under a dp=2 mesh, batch 8: the final wire buffer
    equals JAX's ``shard_map`` executor's and the port's on one device, the
    keys copied once a position's device, and it decrypts to the
    circuit."""
    circ, jprog = mapped("full_adder")
    jk = J.generate_keys(J.TEST_PARAMS, seed=7)
    rng = np.random.default_rng(8)
    values = {i.name: rng.integers(0, 2, 8) for i in circ.inputs}
    want, whole, shards, ex = executor_runs(jprog, jk, carried(jk), values,
                                            orientation, 2, seed=9)
    assert len(shards) == 2 and all(s.shape[1] == 4 for s in shards)
    assert ex._replica(CPU)[1].orientation == orientation
    got = torch.cat(shards, dim=1)
    assert torch.equal(got, whole)
    assert np.array_equal(got.numpy(), want)
    outs = ex.decrypt_outputs(shards)
    for k, w in circ.eval(values).items():
        assert np.array_equal(np.asarray(w), outs[k]), k


def test_checkpoint_written_at_dp4_resumes_at_dp1_and_dp2(tmp_path):
    """The snapshot is the whole buffer in the JAX format; it resumes on any
    mesh, or on none, to the same final buffer.  The resumed runs start
    from a zero buffer, so only the snapshot can make them right."""
    _, prog = mapped("ascon_lut")
    keys = T.generate_keys(T.TEST_PARAMS, seed=11, device="cpu")
    rng = np.random.default_rng(0)
    values = {n.name: rng.integers(0, 2, 8)
              for n in prog.nodes if n.kind == "input"}
    ex4 = CircuitExecutor(prog, keys, mesh=cpu_mesh(4))
    assert len(ex4.levels) >= 2
    buf4 = ex4.encrypt_inputs(values, np.random.default_rng(1))
    full = torch.cat(ex4.run(buf4), dim=1)
    ckpt = str(tmp_path / "run.npz")
    ex4.run(buf4, checkpoint=ckpt, checkpoint_every=1)
    with np.load(ckpt) as z:
        assert set(z.files) == {"buf", "level", "num_levels"}
        assert int(z["level"]) == len(ex4.levels) - 2
        assert z["buf"].shape == tuple(full.shape)
    for mesh in (cpu_mesh(1), cpu_mesh(2), None):
        ex = CircuitExecutor(prog, keys, mesh=mesh)
        zeros = torch.zeros_like(full)
        start = zeros if mesh is None else shard_batch(mesh, zeros, axis=1)
        got = ex.run(start, checkpoint=ckpt, checkpoint_every=1)
        got = got if mesh is None else torch.cat(got, dim=1)
        assert torch.equal(got, full), mesh
    assert ex.decrypt_outputs(got).keys() == prog.outputs.keys()


def test_mesh_refusals():
    _, prog = mapped("full_adder")
    keys = T.generate_keys(T.TEST_PARAMS, seed=2, device="cpu")
    ex = CircuitExecutor(prog, keys, mesh=cpu_mesh(4))
    values = {n.name: np.zeros(6, np.int64)
              for n in prog.nodes if n.kind == "input"}
    with pytest.raises(ValueError, match=r"batch 6 must be divisible by the "
                                         r"dp axis \(4\)"):
        ex.encrypt_inputs(values, np.random.default_rng(0))
    values = {k: np.zeros(8, np.int64) for k in values}
    shards = ex.encrypt_inputs(values, np.random.default_rng(0))
    with pytest.raises(TypeError, match="list of shards"):
        ex.run(torch.cat(shards, dim=1))
    with pytest.raises(TypeError, match="list of shards"):
        CircuitExecutor(prog, keys).run(shards)


def test_init_distributed_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0
    distributed.barrier()
    outs = {"a": np.arange(3)}
    assert gather_outputs(outs) is outs
    mesh = global_mesh(devices=["cpu"] * 2)
    assert mesh.shape == {"dp": 2, "tp": 1} and not mesh.spans_processes
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed()
    assert not torch.distributed.is_initialized()


def test_dryrun_takes_the_jax_dry_run_families():
    """The port's dry run runs the JAX dry run's families on both devices:
    the sharded FBS at ``_tiny_setup``'s (N=64), the full adder at
    ``TEST_PARAMS`` and the staged program at the two families
    ``_dryrun_staged_executor`` builds (N=256 and N=128)."""
    import ast
    import inspect
    from tfhe_fbs_map_tpu_torch.tfhe.params import (STAGED_PRESETS,
                                                    TEST_PARAMS)

    assert vars(dryrun.DRYRUN_PARAMS) == vars(G._tiny_setup()[0])
    assert "TEST_PARAMS" in inspect.getsource(G._dryrun_mesh_executor)
    assert vars(TEST_PARAMS) == vars(J.TEST_PARAMS)
    tree = ast.parse(inspect.getsource(G._dryrun_staged_executor).strip())
    fams = [{kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
            for node in ast.walk(tree) if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "TFHEParams"]
    staged = STAGED_PRESETS["staged_test"]
    assert fams == [vars(staged.fam1), vars(staged.fam2)]
    assert "generate_staged_keys(32, f1, f2, seed=3)" in inspect.getsource(
        G._dryrun_staged_executor)


def test_dryrun_on_the_cpu(capsys):
    assert dryrun.main(["--device", "cpu", "--dp", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("]")[0] for line in lines] == [
        "dryrun_multichip[fbs", "dryrun_multichip[executor/full_adder",
        "dryrun_multichip[staged-executor/p32",
        "dryrun_multichip[entry/matmul", "dryrun_multichip[matmul/tp"]
    assert all(line.endswith("bit_exact=True") for line in lines)
    # JAX's matmul run at tp=2 on an even count of at least 4 positions
    assert "mesh={'dp': 2, 'tp': 2}" in lines[-1]


# experiments/bench_multichip.py:117-127, the JAX script's JSON keys
MULTICHIP_KEYS = {"metric", "value", "devices", "dp", "tp",
                  "boots_per_sec_per_chip", "batch_per_chip", "orientation",
                  "errors"}


def test_bench_multichip_quick_as_a_command():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m",
                          "tfhe_fbs_map_tpu_torch.bench_multichip", "--quick",
                          "--cpu-devices", "4"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) == MULTICHIP_KEYS
    assert out["errors"] == 0 and out["dp"] == 4 and out["tp"] == 1
    assert out["devices"] == 1 and out["batch_per_chip"] == 16
    # per-chip figures divide by the positions used
    assert abs(out["boots_per_sec_per_chip"] * 4 - out["value"]) < 1.0


@pytest.mark.parametrize("argv", [["--quick", "--cpu-devices", "2", "--tp",
                                   "2"], ["--quick"], ["--quick", "--dp", "2"],
                                  ["--quick", "--cpu-devices", "2", "--dp",
                                   "2"]])
def test_bench_multichip_refusals(argv, capsys, monkeypatch):
    """--tp 2 without --orientation matmul, no mesh without a GPU unless
    --cpu-devices, and --dp (the GPUs' positions) beside --cpu-devices:
    exit 2."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert bench_multichip.main(argv) == 2
    assert capsys.readouterr().out == ""
