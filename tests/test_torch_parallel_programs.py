"""The port's mesh executor on larger programs, against the JAX package's
mesh executor on the conftest's 8 virtual devices and the port on one
device: mapped aes_sbox at dp 8 and the dry run's staged p=32 program at
dp 4 (final wire buffers bitwise; ``test_torch_parallel.py`` has the rest
of the mesh)."""

import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu.frontend.lut_program import LutProgram as JProgram
from tfhe_fbs_map_tpu.tfhe.staged import generate_staged_keys as jstaged
from tfhe_fbs_map_tpu_torch.parallel import dryrun
from tfhe_fbs_map_tpu_torch.tfhe.keys import staged_keys_from_numpy
from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS

from test_torch_parallel import (carried, executor_runs, key_arrays, mapped,
                                 to_port)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)


def test_mesh_executor_aes_sbox():
    """Realistic shapes (at least 40 bootstraps over at least 8 levels) at
    dp 8, batch 8, generic: the final wire buffer equals JAX's mesh
    executor's and the port's on one device."""
    circ, jprog = mapped("aes_sbox")
    jk = J.generate_keys(J.TEST_PARAMS, seed=3)
    rng = np.random.default_rng(4)
    values = {i.name: rng.integers(0, 2, 8) for i in circ.inputs}
    want, whole, shards, ex = executor_runs(jprog, jk, carried(jk), values,
                                            None, 8, seed=5)
    assert ex.num_bootstraps >= 40 and len(ex.levels) >= 8
    got = torch.cat(shards, dim=1)
    assert torch.equal(got, whole) and np.array_equal(got.numpy(), want)
    outs = ex.decrypt_outputs(shards)
    for k, w in circ.eval(values).items():
        assert np.array_equal(np.asarray(w), outs[k]), k


def jax_address_lut(rng):
    """The JAX dry run's staged p=32 program (``__graft_entry__
    ._dryrun_staged_executor``), built with the JAX package."""
    prog = JProgram()
    w = [prog.input(f"w{i}") for i in range(5)]
    table = rng.integers(0, 2, 32)
    table[0] = 0
    addr = prog.linear([1, 2, 4, 8, 16], w, 0)
    a = prog.bootstrap(addr, table.tolist())
    lin_b = prog.linear([1, 2], [a, w[0]], 0)
    prog.output("o", prog.bootstrap(lin_b, [0, 1, 1, 0]))
    prog.output("a", a)
    return prog


@pytest.mark.parametrize("orientation", [None, "fused_otf"])
def test_mesh_executor_staged_p32(orientation):
    """The dry run's staged program at dp 4 on the ``staged_test`` families
    (the JAX dry run's): the port's final wire buffer, generic or through
    K1's plain version, equals JAX's generic staged mesh executor's and the
    port's on one device."""
    preset = STAGED_PRESETS["staged_test"]
    f1, f2 = (J.TFHEParams(**vars(f)) for f in (preset.fam1, preset.fam2))
    jsk = jstaged(32, f1, f2, seed=3)
    tsk = staged_keys_from_numpy(32, key_arrays(jsk.keys1),
                                 key_arrays(jsk.keys2), device="cpu")
    rng = np.random.default_rng(4)
    jprog = jax_address_lut(rng)
    # the port's copy of the program is the same program
    assert to_port(jprog).stats() == dryrun.address_lut_program(
        np.random.default_rng(4)).stats()
    values = {f"w{i}": rng.integers(0, 2, 8) for i in range(5)}
    want, whole, shards, ex = executor_runs(jprog, jsk, tsk, values,
                                            orientation, 4, seed=5,
                                            jax_fast=False)
    assert ex.staged and ex.plan.route_counts["split"] == 1
    got = torch.cat(shards, dim=1)
    assert torch.equal(got, whole) and np.array_equal(got.numpy(), want)
    outs = ex.decrypt_outputs(shards)
    for k, w in jprog.eval(values).items():
        assert np.array_equal(np.asarray(w) % 64, outs[k] % 64), k
