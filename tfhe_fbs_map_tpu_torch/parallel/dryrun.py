"""Dry run of the mesh: a batched FBS, the full-adder executor, the staged
p=32 executor and the matmul orientation, each held bit-exact to one
device.

    python -m tfhe_fbs_map_tpu_torch.parallel.dryrun --device cpu --dp 8
    python -m tfhe_fbs_map_tpu_torch.parallel.dryrun --dp 2   # on the GPUs

The counterpart of ``__graft_entry__.dryrun_multichip`` (the JAX package's
``MULTICHIP_r0*.json`` came from it):

* :func:`sharded_fbs`: :func:`.mesh.sharded_bootstrap` of a batch against
  one device's :func:`..ops.blind_rotate.functional_bootstrap_fast`;
* :func:`full_adder`: a full adder (the port's ``BitCircuit``, mapped by the
  search mapper) through :class:`..runtime.executor.CircuitExecutor` under
  the mesh against the same run on one device;
* :func:`staged_p32`: the size-32 address-LUT program (a two-stage split
  and a select) through the staged executor under the mesh, likewise;
* :func:`entry_fbs`: ``__graft_entry__.entry``'s single-device FBS, the
  ``"matmul"`` orientation, against the fused kernel's and the values;
* :func:`sharded_fbs` again through ``"matmul"``, the JAX dry run's
  "matmul/GSPMD" run: on a (dp/2, 2) mesh of the same positions where
  they are even and at least 4 (the key contraction split over tp=2),
  else on the dp mesh.

Each part returns its mesh's shape, its launches of the fused kernels
under the mesh (none through ``"matmul"``) and whether the mesh's result
is bitwise equal to the one device's and decrypts to the oracle.  The
parts take the JAX dry run's own families on both devices:
:data:`DRYRUN_PARAMS` (N=64) for the sharded FBS and the matmul runs,
``TEST_PARAMS`` for the full adder and the ``staged_test`` families (f1
N=256, f2 N=128, keys from seed 3) for the staged program, all but the
matmul runs through K1 (on the CPU through its plain version; on the card
N < 256 through its small-N kernel).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import fused_blind_rotate as fbr
from ..tfhe.params import TFHEParams
from .mesh import Mesh, make_mesh, shard_batch, sharded_bootstrap

__all__ = ["DRYRUN_PARAMS", "sharded_fbs", "mesh_against_one_device",
           "full_adder", "staged_p32", "address_lut_program", "entry_fbs",
           "matmul_mesh", "dryrun", "main"]

# the JAX dry run's tiny family (__graft_entry__.py _tiny_setup)
DRYRUN_PARAMS = TFHEParams(p=4, lwe_dim=8, glwe_dim=1, poly_size=64,
                           bsk_level=2, bsk_base_log=7, ksk_level=2,
                           ksk_base_log=4, lwe_noise_std=2.0,
                           glwe_noise_std=2.0)


def _sync(mesh: Mesh) -> None:
    for d in mesh.distinct:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counted(mesh: Mesh, fn):
    """``fn()``, the fused-kernel launches it made, K1's of them by kernel
    (``fbr.K1_KERNELS``) and its wall seconds."""
    _sync(mesh)
    before, kernels = dict(fbr.LAUNCHES), dict(fbr.K1_KERNELS)
    t0 = time.time()
    out = fn()
    _sync(mesh)
    return out, {k: fbr.LAUNCHES[k] - before[k] for k in before}, \
        {k: fbr.K1_KERNELS[k] - kernels[k] for k in kernels}, \
        time.time() - t0


def _identity_batch(params, batch: int, seed: int, dev: torch.device):
    """Keys from ``seed`` and ``batch`` encrypted bits under the identity
    table: (keys, values, ciphertexts, test polynomials, offsets)."""
    from ..tfhe import build_test_vector, encrypt_values, generate_keys

    keys = generate_keys(params, seed=seed, device=dev)
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 2, batch)
    cts = encrypt_values(keys, values, rng)
    tv, post = build_test_vector([0, 1], params)
    tvs = torch.from_numpy(np.tile(np.asarray(tv, np.int32), (batch, 1))) \
        .to(dev)
    posts = torch.full((batch,), int(np.int64(post).astype(np.uint32)
                                     .astype(np.int32)),
                       dtype=torch.int32, device=dev)
    return keys, values, cts, tvs, posts


def sharded_fbs(mesh: Mesh, params, orientation: str, batch: int,
                seed: int = 5) -> dict:
    """``batch`` ciphertexts of bits through the identity table, sharded
    over ``mesh`` and on its first device alone."""
    from ..ops.blind_rotate import (functional_bootstrap_fast,
                                    prepare_fast_keys)
    from ..tfhe import decrypt_values

    dev = mesh.devices[0]
    keys, values, cts, tvs, posts = _identity_batch(params, batch, seed, dev)
    fast = prepare_fast_keys(keys, orientation=orientation)
    want = functional_bootstrap_fast(fast, cts, tvs, posts)
    fn = sharded_bootstrap(mesh, fast)
    shards = [shard_batch(mesh, x) for x in (cts, tvs, posts)]
    got, launches, kernels, _ = _counted(mesh, lambda: fn(*shards))
    got = torch.cat([g.to(dev) for g in mesh.leaders(got)])
    return {"part": "fbs" if orientation != "matmul" else "matmul/tp",
            "mesh": mesh.shape, "batch": batch, "launches": launches,
            "k1_kernels": kernels,
            "bit_exact": bool(torch.equal(got, want)) and np.array_equal(
                decrypt_values(keys, got), values)}


def entry_fbs(device, params=DRYRUN_PARAMS, batch: int = 8,
              seed: int = 0) -> dict:
    """``__graft_entry__.entry``'s forward step on one device: the
    ``"matmul"`` FBS of ``batch`` encrypted bits (its ``_tiny_setup``: seed
    0, the identity table), bitwise against the fused kernel's
    (``"fused_otf"``) and decrypting to the bits."""
    from ..ops.blind_rotate import (functional_bootstrap_fast,
                                    prepare_fast_keys)
    from ..tfhe import decrypt_values

    dev = torch.device(device)
    keys, values, cts, tvs, posts = _identity_batch(params, batch, seed, dev)
    mm = prepare_fast_keys(keys, orientation="matmul")
    mesh = make_mesh([dev])
    got, launches, _, _ = _counted(
        mesh, lambda: functional_bootstrap_fast(mm, cts, tvs, posts))
    want = functional_bootstrap_fast(
        prepare_fast_keys(keys, orientation="fused_otf"), cts, tvs, posts)
    return {"part": "entry/matmul", "mesh": mesh.shape, "batch": batch,
            "launches": launches,
            "bit_exact": bool(torch.equal(got, want)) and np.array_equal(
                decrypt_values(keys, got), values)}


def matmul_mesh(mesh: Mesh) -> Mesh:
    """The JAX dry run's mesh for its matmul run: the same positions as
    (dp/2, 2) where there are an even number, at least 4, else ``mesh``."""
    n = len(mesh.devices)
    if mesh.spans_processes or n % 2 or n < 4:
        return mesh
    return make_mesh(mesh.devices, tp=2)


def mesh_against_one_device(mesh: Mesh, prog, keys, fast, values,
                            seed: int, oracle,
                            modulus: int | None = None) -> dict:
    """``prog`` run under ``mesh`` and on its first device alone, with the
    same keys and the inputs encrypted from ``default_rng(seed)`` (on the
    card each executor's graphs captured before its timed run): whether
    the final wire buffers are bitwise equal and the mesh's decryptions
    equal ``oracle`` (mod ``modulus`` where given); the mesh run's
    fused-kernel launches and both runs' wall seconds; the family calls a
    run makes (one a level, or one a non-empty family call of a staged
    level), each launched once a position through a fused kernel."""
    from ..runtime.executor import CircuitExecutor

    one = CircuitExecutor(prog, keys, fast_keys=fast)
    buf1 = one.encrypt_inputs(values, np.random.default_rng(seed))
    one.capture(buf1)
    want, _, _, one_s = _counted(mesh, lambda: one.run(buf1))
    ex = CircuitExecutor(prog, keys, fast_keys=fast, mesh=mesh)
    buf0 = ex.encrypt_inputs(values, np.random.default_rng(seed))
    ex.capture(buf0)
    shards, launches, kernels, run_s = _counted(mesh, lambda: ex.run(buf0))
    got = torch.cat([s.to(want.device) for s in shards], dim=1)
    outs = ex.decrypt_outputs(shards)

    def same(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.array_equal(a % modulus, b % modulus) if modulus \
            else np.array_equal(a, b)
    calls = (sum(bool(lv.wire_idx1.shape[0]) + bool(lv.wire_idx2.shape[0])
                 for lv in ex.levels) if ex.staged else len(ex.levels))
    return {"mesh": mesh.shape,
            "batch": len(next(iter(values.values()))), "launches": launches,
            "k1_kernels": kernels, "levels": len(ex.levels), "calls": calls,
            "bootstraps": ex.num_bootstraps, "run_s": run_s, "one_s": one_s,
            "bit_exact": bool(torch.equal(got, want))
            and all(same(oracle[k], outs[k]) for k in oracle)}


def full_adder(mesh: Mesh, params, orientation: str | None, batch: int,
               seed: int = 1) -> dict:
    """A mapped full adder through the mesh executor (``orientation``
    None: the generic bootstrap)."""
    from ..frontend import BitCircuit, HeuristicMapper
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe import generate_keys

    circ = BitCircuit()
    a, b, cin = (circ.add_input(n) for n in ("a", "b", "cin"))
    p = circ.xor_(a, b)
    circ.set_output("sum", circ.xor_(p, cin))
    circ.set_output("cout", circ.or_(circ.and_(a, b), circ.and_(p, cin)))
    prog = HeuristicMapper(cone_merger="search", fbs_size=params.p).map(circ)
    prog.remove_dangling_nodes()
    keys = generate_keys(params, seed=0, device=mesh.devices[0])
    fast = (None if orientation is None
            else prepare_fast_keys(keys, orientation=orientation))
    rng = np.random.default_rng(seed)
    values = {n: rng.integers(0, 2, batch) for n in ("a", "b", "cin")}
    res = mesh_against_one_device(mesh, prog, keys, fast, values, seed + 1,
                                  circ.eval(values))
    return {"part": "executor/full_adder", **res}


def address_lut_program(rng: np.random.Generator):
    """The JAX dry run's p=32 program: a random 32-entry table over a 5-bit
    address (a two-stage split) and a 4-entry table of its output and one
    address bit."""
    from ..frontend.lut_program import LutProgram

    prog = LutProgram()
    w = [prog.input(f"w{i}") for i in range(5)]
    table = rng.integers(0, 2, 32)
    table[0] = 0
    addr = prog.linear([1, 2, 4, 8, 16], w, 0)
    a = prog.bootstrap(addr, table.tolist())
    lin_b = prog.linear([1, 2], [a, w[0]], 0)
    prog.output("o", prog.bootstrap(lin_b, [0, 1, 1, 0]))
    prog.output("a", a)
    return prog


def staged_p32(mesh: Mesh, fam1, fam2, orientation: str | None,
               batch: int, seed: int = 3) -> dict:
    """The address-LUT program through the staged mesh executor over the
    families ``fam1``/``fam2`` (both through ``orientation``'s kernel, or
    the generic bootstrap for None)."""
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe.staged import generate_staged_keys

    skeys = generate_staged_keys(32, fam1, fam2, seed=seed,
                                 device=mesh.devices[0])
    fast = (None if orientation is None else tuple(
        prepare_fast_keys(k, orientation=orientation)
        for k in (skeys.keys1, skeys.keys2)))
    rng = np.random.default_rng(seed + 1)
    prog = address_lut_program(rng)
    values = {f"w{i}": rng.integers(0, 2, batch) for i in range(5)}
    res = mesh_against_one_device(mesh, prog, skeys, fast, values, seed + 2,
                                  prog.eval(values), modulus=64)
    return {"part": "staged-executor/p32", **res}


def dryrun(mesh: Mesh) -> list[dict]:
    """The five parts on ``mesh`` (this process's positions only), at the
    JAX dry run's families."""
    from ..tfhe.params import STAGED_PRESETS, TEST_PARAMS

    if mesh.spans_processes:
        raise ValueError("the dry run takes a mesh of one process")
    staged = STAGED_PRESETS["staged_test"]
    dp = mesh.dp
    return [sharded_fbs(mesh, DRYRUN_PARAMS, "fused_otf", 8 * dp),
            full_adder(mesh, TEST_PARAMS, "fused_otf", 2 * dp),
            staged_p32(mesh, staged.fam1, staged.fam2, "fused_otf", 2 * dp),
            entry_fbs(mesh.devices[0]),
            sharded_fbs(matmul_mesh(mesh), DRYRUN_PARAMS, "matmul", 8 * dp)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dp", type=int, default=None,
                    help="mesh positions (default: every visible GPU; 8 on "
                         "the CPU); on CUDA dealt round-robin over the GPUs")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        mesh = make_mesh(["cpu"] * (args.dp or 8))
    else:
        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available",
                  file=sys.stderr)
            return 2
        mesh = make_mesh(dp=args.dp)
    results = dryrun(mesh)
    for res in results:
        print(f"dryrun_multichip[{res['part']}]: mesh={res['mesh']} "
              f"batch={res['batch']} launches={res['launches']} "
              f"bit_exact={res['bit_exact']}")
    return 0 if all(r["bit_exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
