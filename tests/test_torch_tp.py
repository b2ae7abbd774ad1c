"""The port's tp axis on the CPU: the ``"matmul"`` orientation's key
contraction split over tp positions (``parallel/mesh.py``), against the
JAX package's GSPMD mesh on the conftest's 8 virtual devices: the key
slices, the sharded FBS at (dp, tp) ∈ {(1, 2), (2, 2), (4, 2)}, the mesh
executor's full adder at (4, 2) (final wire buffers bitwise), the runtime
CLI at ``--mesh 2,2``, ``global_mesh``'s rule, ``bench_multichip --tp 2``
and the dry run's matmul runs; the fused orientations refuse tp > 1.  The
tolerance of every comparison is 0."""

import io
import json
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
from tfhe_fbs_map_tpu.runtime.cli import main as jax_cli
from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor as JExecutor
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch import bench_multichip
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    functional_bootstrap_fast, prepare_fast_keys)
from tfhe_fbs_map_tpu_torch.parallel import (dryrun, global_mesh, make_mesh,
                                             shard_batch, shard_fast_keys,
                                             sharded_bootstrap)
from tfhe_fbs_map_tpu_torch.runtime.cli import main as cli_main
from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
from tfhe_fbs_map_tpu_torch.tfhe.keys import keys_from_numpy

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import __graft_entry__ as G  # noqa: E402

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

CPU = torch.device("cpu")


def carried(jk):
    return keys_from_numpy(T.TFHEParams(**vars(jk.params)),
                           np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
                           np.asarray(jk.bsk), np.asarray(jk.ksk),
                           device="cpu")


def cpu_mesh(dp, tp):
    return make_mesh(["cpu"] * (dp * tp), tp=tp)


@pytest.fixture(scope="module")
def tiny():
    """The JAX dry run's tiny setup (N=64, batch 8; its matmul keys) and
    the port's copy of the keys and operands."""
    params, jfast, cts, tvs, posts = G._tiny_setup(seed=5)
    jk = J.generate_keys(params, seed=5)
    jfast = jprep(jk, orientation="matmul")
    args = [torch.from_numpy(np.array(x)) for x in (cts, tvs, posts)]
    return jfast, (cts, tvs, posts), prepare_fast_keys(carried(jk),
                                                       "matmul"), args


# ---------------------------------------------------------------- mesh

def test_mesh_is_dp_major_with_tp_innermost():
    mesh = cpu_mesh(2, 2)
    assert mesh.shape == {"dp": 2, "tp": 2} and not mesh.spans_processes
    assert mesh.groups("abcd") == [["a", "b"], ["c", "d"]]
    assert mesh.leaders("abcd") == ["a", "c"]
    x = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    shards = shard_batch(mesh, x, axis=1)
    # split over dp, repeated over tp
    assert [s.tolist() for s in shards] == [x[:, :3].tolist()] * 2 \
        + [x[:, 3:].tolist()] * 2
    assert make_mesh(["cpu"] * 4, tp=2).dp == 2
    with pytest.raises(ValueError, match="cannot form mesh"):
        make_mesh(["cpu"] * 4, dp=3, tp=2)
    with pytest.raises(ValueError, match="at least one position"):
        make_mesh(["cpu"] * 4, tp=0)


@pytest.mark.parametrize("tp", [16, 3, 0])
def test_global_mesh_rejects_tp_that_does_not_divide_the_local_positions(
        tp):
    """JAX's rule (``test_parallel.py:119-126``): tp must divide the local
    device count, so a tp group never spans processes."""
    with pytest.raises(ValueError, match="must divide the 8 local"):
        global_mesh(tp=tp, devices=["cpu"] * 8)


def test_global_mesh_takes_a_dividing_tp():
    mesh = global_mesh(tp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "tp": 2}


def test_keys_slices_equal_jax_shards(tiny):
    """Under (2, 2) each tp position holds JAX's shard of the matmul keys
    (``P(None, "tp", None)`` on [n, T, D]; the port's slice is its
    transpose) and its share of the key switch's rows; one copy a
    (device, slice)."""
    jfast, _, fast, _ = tiny
    jm = jmesh.make_mesh(jax.devices()[:4], dp=2, tp=2)
    js = jmesh.shard_fast_keys(jm, jfast)
    keys = shard_fast_keys(cpu_mesh(2, 2), fast)
    assert sorted(keys) == [(CPU, 0), (CPU, 1)]
    for shard in js.bsk_kernels.addressable_shards[:2]:
        j = jm.devices.tolist()[0].index(shard.device)
        assert np.array_equal(keys[(CPU, j)].bsk_kernels.numpy(),
                              np.asarray(shard.data).transpose(0, 2, 1))
    for shard in js.ksk_limbs.addressable_shards[:2]:
        j = jm.devices.tolist()[0].index(shard.device)
        assert np.array_equal(keys[(CPU, j)].ksk_limbs.numpy(),
                              np.asarray(shard.data))


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2)])
def test_sharded_bootstrap_equals_jax(tiny, dp, tp):
    """The port's sharded matmul FBS equals its one-device FBS and JAX's
    GSPMD ``sharded_bootstrap`` (``test_parallel.py:25-55``); every
    position of a tp group returns the group's outputs."""
    jfast, jargs, fast, args = tiny
    jm = jmesh.make_mesh(jax.devices()[:dp * tp], dp=dp, tp=tp)
    jfn = jmesh.sharded_bootstrap(jm, jmesh.shard_fast_keys(jm, jfast))
    want = np.asarray(jfn(*(jmesh.shard_batch(jm, x) for x in jargs)))
    mesh = cpu_mesh(dp, tp)
    got = sharded_bootstrap(mesh, fast)(*(shard_batch(mesh, x)
                                          for x in args))
    assert len(got) == dp * tp
    for group in mesh.groups(got):
        assert all(torch.equal(g, group[0]) for g in group)
    whole = torch.cat(mesh.leaders(got))
    assert torch.equal(whole, functional_bootstrap_fast(fast, *args))
    assert np.array_equal(whole.numpy(), want)


@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_fused_orientations_refuse_tp(tiny, orientation):
    """The fused kernels are dp-only: their keys replicate, and tp > 1 is
    refused where the mesh meets the keys, naming the orientation that
    takes it."""
    fast = prepare_fast_keys(carried(J.generate_keys(G._tiny_setup()[0],
                                                     seed=1)), orientation)
    mesh = cpu_mesh(2, 2)
    for call in (lambda: shard_fast_keys(mesh, fast),
                 lambda: sharded_bootstrap(mesh, fast)):
        with pytest.raises(ValueError, match="--orientation matmul"):
            call()
    assert list(shard_fast_keys(cpu_mesh(2, 1), fast)) == [CPU]


# ------------------------------------------------------- mesh executor

@pytest.fixture(scope="module")
def full_adder():
    circ = build_bench("full_adder")
    jprog = HeuristicMapper(cone_merger="search",
                            fbs_size=J.TEST_PARAMS.p).map(circ)
    jprog.remove_dangling_nodes()
    out = io.StringIO()
    jprog.write_lbf(out)
    jk = J.generate_keys(J.TEST_PARAMS, seed=7)
    rng = np.random.default_rng(8)
    values = {i.name: rng.integers(0, 2, 16) for i in circ.inputs}
    return circ, jprog, parse_lbf(out.getvalue()), jk, carried(jk), values


def test_mesh_executor_full_adder_at_4_2_equals_jax(full_adder):
    """dp 4 × tp 2, batch 16, matmul keys: the final wire buffer (each dp
    group's first position) equals JAX's GSPMD mesh executor's
    (``test_parallel.py:87-100``) and the port's on one device, every
    position of a group holds the same, and it decrypts to the circuit."""
    circ, jprog, prog, jk, tk, values = full_adder
    jm = jmesh.make_mesh(jax.devices(), dp=4, tp=2)
    jex = JExecutor(jprog, jk, fast_keys=jprep(jk, "matmul"), mesh=jm)
    want = np.asarray(jex.run(jex.encrypt_inputs(
        values, np.random.default_rng(9))))
    fast = prepare_fast_keys(tk, "matmul")
    one = CircuitExecutor(prog, tk, fast_keys=fast)
    whole = one.run(one.encrypt_inputs(values, np.random.default_rng(9)))
    ex = CircuitExecutor(prog, tk, fast_keys=fast, mesh=cpu_mesh(4, 2))
    shards = ex.run(ex.encrypt_inputs(values, np.random.default_rng(9)))
    assert len(shards) == 8 and ex.capture(shards) == 0
    with pytest.raises(ValueError, match="tp group"):
        ex.step(shards[0], 0)
    for group in ex.mesh.groups(shards):
        assert torch.equal(group[0], group[1])
    got = torch.cat(ex.mesh.leaders(shards), dim=1)
    assert torch.equal(got, whole)
    assert np.array_equal(got.numpy(), want)
    outs = ex.decrypt_outputs(shards)
    for k, w in circ.eval(values).items():
        assert np.array_equal(np.asarray(w), outs[k]), k


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 3)])
def test_mesh_executor_equals_one_device(full_adder, dp, tp):
    """Other (dp, tp) meshes, tp=3 padding the contraction: the final
    buffer equals the one-device run's."""
    _, _, prog, _, tk, values = full_adder
    fast = prepare_fast_keys(tk, "matmul")
    one = CircuitExecutor(prog, tk, fast_keys=fast)
    whole = one.run(one.encrypt_inputs(values, np.random.default_rng(9)))
    ex = CircuitExecutor(prog, tk, fast_keys=fast, mesh=cpu_mesh(dp, tp))
    shards = ex.run(ex.encrypt_inputs(values, np.random.default_rng(9)))
    assert torch.equal(torch.cat(ex.mesh.leaders(shards), dim=1), whole)


def test_checkpoint_written_at_tp2_resumes_on_one_device(full_adder,
                                                         tmp_path):
    """A tp > 1 run saves each dp group's buffer once, the whole batch in
    the JAX format, and resumes on one device to the same buffer."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import LutProgram
    _, _, _, _, tk, _ = full_adder
    prog = LutProgram()                   # two levels
    a, b = prog.input("a"), prog.input("b")
    x = prog.bootstrap(prog.linear([1, 1], [a, b], 0), [0, 1, 0])
    prog.output("y", prog.bootstrap(prog.linear([1, 1], [x, a], 0),
                                    [1, 0, 1]))
    rng = np.random.default_rng(10)
    values = {n: rng.integers(0, 2, 8) for n in "ab"}
    fast = prepare_fast_keys(tk, "matmul")
    ex = CircuitExecutor(prog, tk, fast_keys=fast, mesh=cpu_mesh(2, 2))
    buf = ex.encrypt_inputs(values, np.random.default_rng(9))
    full = torch.cat(ex.mesh.leaders(ex.run(buf)), dim=1)
    ckpt = str(tmp_path / "run.npz")
    ex.run(buf, checkpoint=ckpt, checkpoint_every=1)
    with np.load(ckpt) as z:
        assert z["buf"].shape == tuple(full.shape)
    one = CircuitExecutor(prog, tk, fast_keys=fast)
    got = one.run(torch.zeros_like(full), checkpoint=ckpt,
                  checkpoint_every=1)
    assert torch.equal(got, full)


def test_executor_refusals(full_adder):
    """tp > 1 takes native matmul keys; the staged executor under a mesh
    the fused orientations (``executor.py:541-548``)."""
    _, _, prog, _, tk, _ = full_adder
    for fast in (None, prepare_fast_keys(tk, "fused_otf")):
        with pytest.raises(ValueError, match="--orientation matmul"):
            CircuitExecutor(prog, tk, fast_keys=fast, mesh=cpu_mesh(2, 2))
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
    staged = STAGED_PRESETS["staged_test"]
    skeys = generate_staged_keys(32, staged.fam1, staged.fam2, seed=3,
                                 device="cpu")
    pair = tuple(prepare_fast_keys(k, "matmul")
                 for k in (skeys.keys1, skeys.keys2))
    prog32 = dryrun.address_lut_program(np.random.default_rng(0))
    with pytest.raises(ValueError, match="fused orientations"):
        CircuitExecutor(prog32, skeys, fast_keys=pair, mesh=cpu_mesh(2, 1))


# ----------------------------------------------------------------- CLI

def test_cli_mesh_2_2_equals_the_jax_cli(full_adder, tmp_path, capsys,
                                         monkeypatch):
    """``--orientation matmul --mesh 2,2 --device cpu --test-params``:
    the JSON's ``mesh`` and stderr's ``# mesh:`` line as the JAX CLI's, and
    the same decoded outputs (same seed, same draws)."""
    from tfhe_fbs_map_tpu.runtime.executor import (
        CircuitExecutor as JEx)
    circ = build_bench("full_adder")
    path = tmp_path / "fa.blif"
    with open(path, "w") as f:
        circ.to_blif(f, model_name="fa")
    decoded = []
    for cls in (JEx, CircuitExecutor):
        decrypt = cls.decrypt_outputs

        def spy(self, buf, decrypt=decrypt):
            out = decrypt(self, buf)
            # JAX's whole buffer, or the port's list of shards (not each)
            if not isinstance(buf, torch.Tensor) or self.mesh is None:
                decoded.append(out)
            return out
        monkeypatch.setattr(cls, "decrypt_outputs", spy)
    argv = [str(path), "--map", "--batch", "8", "--test-params",
            "--orientation", "matmul", "--mesh", "2,2"]
    lines = []
    for main, extra in ((jax_cli, []), (cli_main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        out = capsys.readouterr()
        assert "# mesh: dp=2 tp=2" in out.err
        lines.append(json.loads(out.out.strip().splitlines()[-1]))
    jres, res = lines
    assert jres["mesh"] == res["mesh"] == {"dp": 2, "tp": 2}
    assert jres["bit_exact"] and res["bit_exact"]
    assert res["orientation"] == "matmul"
    assert len(decoded) == 2 and decoded[0].keys() == decoded[1].keys()
    for k in decoded[0]:
        assert np.array_equal(np.asarray(decoded[0][k]), decoded[1][k]), k


# --------------------------------------------- bench_multichip, dry run

def test_bench_multichip_tp2_matmul(capsys):
    """``bench_multichip --quick --cpu-devices 4 --tp 2 --orientation
    matmul``: dp 2 groups of 2 positions, errors 0, per-chip figures over
    the 4 positions."""
    assert bench_multichip.main(["--quick", "--cpu-devices", "4", "--tp",
                                 "2", "--orientation", "matmul"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["dp"], out["tp"], out["errors"]) == (2, 2, 0)
    assert out["orientation"] == "matmul"
    assert abs(out["boots_per_sec_per_chip"] * 4 - out["value"]) < 1.0


def test_dryrun_matmul_runs():
    """The dry run's matmul parts: ``__graft_entry__.entry``'s FBS on one
    device and the "matmul/GSPMD" run, on (dp/2, 2) where the positions
    are even and at least 4 (JAX's rule), else on the dp mesh."""
    assert dryrun.matmul_mesh(make_mesh(["cpu"] * 4)).shape == {"dp": 2,
                                                                "tp": 2}
    assert dryrun.matmul_mesh(make_mesh(["cpu"] * 2)).shape == {"dp": 2,
                                                                "tp": 1}
    assert dryrun.matmul_mesh(make_mesh(["cpu"] * 6)).shape == {"dp": 3,
                                                                "tp": 2}
    entry = dryrun.entry_fbs("cpu")
    assert entry["bit_exact"] and entry["batch"] == 8
    assert entry["launches"] == {"k1": 0, "k2": 0}
    part = dryrun.sharded_fbs(dryrun.matmul_mesh(make_mesh(["cpu"] * 4)),
                              dryrun.DRYRUN_PARAMS, "matmul", 32)
    assert part["bit_exact"] and part["mesh"] == {"dp": 2, "tp": 2}
