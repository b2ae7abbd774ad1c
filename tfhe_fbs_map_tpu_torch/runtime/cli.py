"""Homomorphic circuit runner on PyTorch: execute mapped ``.lbf`` programs.

The counterpart of ``python -m tfhe_fbs_map_tpu.runtime``: load or map a
circuit, pick the parameters, generate keys, encrypt random inputs, run every
level batched on the device, decrypt, and check the outputs against
``LutProgram.eval``.  The last line of standard output is the same JSON
object, with the run's picks and the runtime model's prediction beside it.

Without ``--params``, ``--test-params`` or ``--keys`` the parameter optimizer
picks them (:func:`optimizer_pick`, the JAX CLI's flow): for an even FBS size
p ≥ 10 the keyless staged probe and ``optimize_staged``, then ``optimize``,
and the launch-aware runtime model routes the program staged or native.  A
preset (``--params aes128_p4``, ``kreyvium_p10_staged``, …) pins them.

    python -m tfhe_fbs_map_tpu_torch.runtime prog.lbf --batch 8 --p-error 1e-7
    python -m tfhe_fbs_map_tpu_torch.runtime prog.lbf --params aes128_p4 --batch 8
    python -m tfhe_fbs_map_tpu_torch.runtime c.blif --map --test-params --device cpu
    python -m tfhe_fbs_map_tpu_torch.runtime prog.lbf --params aes128_p4 --mesh auto
    torchrun --nproc-per-node 2 -m tfhe_fbs_map_tpu_torch.runtime prog.lbf \\
        --params aes128_p4 --mesh auto

``--mesh`` runs the executor dp-parallel over the evaluation batch
(:mod:`..parallel`).  Under ``torchrun`` (or ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set by hand) every process
builds the same keys and whole-batch ciphertexts from ``--seed`` and runs
its slice; ``run_s`` is the wall time between two barriers around the run,
and process 0 alone prints the JSON line of the gathered outputs.

On a CUDA device the executor replays one CUDA graph a level group
(:meth:`..runtime.executor.CircuitExecutor.run`); they are captured after
the inputs are encrypted and before the timed window (``# graphs:`` on
stderr), so ``run_s`` is replay alone.  ``--checkpoint`` runs the first
repeat's levels one by one, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.blind_rotate import FUSED_HEADROOM, N_LIMBS, pick_kernel
from ..ops.fused_blind_rotate import unsupported

__all__ = ["main", "pick_orientations", "check_kernel", "optimizer_pick",
           "staged_solution", "Pick", "NoParameters", "FUSED_HEADROOM",
           "STAGED_MARGIN", "free_memory", "predicted_run_s", "family_json"]

# Route staged only when its predicted runtime beats native's by this
# factor; the launch-aware runtime model prices the per-level launches and
# the padding, so the default trusts it.
STAGED_MARGIN = 1.0


def pick_orientations(families, device: torch.device,
                      free_bytes: int | None = None,
                      bsk_limbs: int = N_LIMBS) -> list[str]:
    """``--orientation auto`` for the parameter families of one run: generic
    on the CPU.  On CUDA one native family takes
    :func:`..ops.blind_rotate.pick_kernel` at the card's free memory (K2,
    "fused", when K2 serves it and its ``bsk_limbs`` key matrices fit with
    ``FUSED_HEADROOM`` to spare, else K1, "fused_otf"): the rule the cost
    model prices.  The two staged families both go to K1, the JAX
    reference's choice at every staged preset: their K2 matrices take 59-67
    GB, and on the Kreyvium preset K1 ran the whole path faster even before
    K2's matrices are built (PERF.md); ``--orientation fused`` still asks
    for K2.  On CUDA it raises ValueError when the kernel picked cannot
    serve a family: the plain bootstrap runs there only when asked for."""
    if device.type != "cuda":
        return ["generic"] * len(families)
    orients = ["fused_otf"] * len(families)
    if len(families) == 1:
        if free_bytes is None:
            free_bytes = free_memory(device)
        orients = [pick_kernel(families[0], free_bytes, bsk_limbs)]
    for p, o in zip(families, orients):
        check_kernel(p, o)
    return orients


def free_memory(device: torch.device) -> int:
    """Device bytes this process can still take: the card's free memory and
    the blocks PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


def check_kernel(params, orientation: str) -> None:
    """Raise ValueError when the CUDA kernel of ``orientation`` cannot
    serve ``params``."""
    why = unsupported(params, otf=orientation == "fused_otf")
    if why is not None:
        raise ValueError(
            f"no fused CUDA kernel ({orientation}) serves these parameters: "
            f"{why}; pass --orientation generic to run the plain PyTorch "
            f"bootstrap on the card")


class NoParameters(Exception):
    """The optimizer found no parameters the run can take."""


class Pick(NamedTuple):
    """What :func:`optimizer_pick` chose: the route, its families (one
    native, or the staged fam1 and fam2), the native family's key limbs,
    the per-bootstrap error probability, and the runtime model's µs per
    evaluation of each route it priced (None where it priced none)."""
    staged: bool
    families: tuple
    bsk_limbs: int
    p_error: float
    native_us: float | None
    staged_us: float | None


def staged_solution(prog, p_run: int, p_error: float | None = None,
                    search=None):
    """The staged families the optimizer picks for ``prog`` at ``p_run``
    (None when none meet the error target), as the JAX CLI and sweep pick
    them: the keyless staged probe, then ``optimize_staged`` over the
    program's route mix, retried at ``big_dim=2048``.  ``search``: the
    staged search (default :func:`..optimizer.optimize_staged`; the sweep
    passes its C++ twin).  Raises ValueError when the program has nodes the
    staged pipeline cannot realize."""
    from ..optimizer import optimize_staged
    from .executor import staged_probe

    search = search or optimize_staged
    kw = {"max_p_error": p_error} if p_error is not None else {}
    eff1, eff2, counts = staged_probe(prog, p_run)
    # the objective is the whole program's cost under its route mix; wires
    # made by fam1 singles carry fam1's noise, so any f1 route takes the
    # conservative max(v1, v2) wire bound
    kw.update(weight1=counts["f1"] + counts["split"],
              weight2=counts["f2"] + counts["split"],
              wires_from_stage2=counts["f1"] == 0)
    sol = search(p_run, eff1, eff2, **kw)
    if sol is None:
        # high effective norms: the kN=2048 master's keys are cleaner
        sol = search(p_run, eff1, eff2, big_dim=2048, **kw)
    return sol


def optimizer_pick(prog, p_run: int, batch: int, staged: str = "auto",
                   p_error: float | None = None,
                   margin: float = STAGED_MARGIN) -> Pick:
    """The parameters of a run, as the JAX CLI picks them
    (``tfhe_fbs_map_tpu/runtime/cli.py:133-241``): for an even ``p_run`` ≥
    10 (unless ``staged`` is "off") :func:`staged_solution`; then
    ``optimize(p_run, norm2_linprod)``; the route is
    staged when ``staged`` is "on", when only the staged search found
    parameters, or when the runtime model prices it below ``margin`` times
    native.  Raises :class:`NoParameters` when no parameters meet the
    target, or when ``staged`` is "on" and the program has no staged
    parameters."""
    from ..optimizer import optimize
    from ..optimizer.runtime_model import (predict_native_us,
                                           predict_staged_us)
    from .executor import native_level_boots, staged_level_routes

    kw = {"max_p_error": p_error} if p_error is not None else {}
    staged_sol = routes = None
    if staged != "off" and p_run >= 10 and p_run % 2 == 0:
        try:
            staged_sol = staged_solution(prog, p_run, p_error)
        except ValueError as e:
            if staged == "on":
                raise NoParameters(f"--staged on: {e}") from e
            print(f"# staged: not realizable ({str(e)[:120]}...)",
                  file=sys.stderr)
        else:
            if staged_sol is not None:
                routes = staged_level_routes(prog, p_run)
    if staged == "on" and staged_sol is None:
        raise NoParameters(f"--staged on: no staged parameters for this "
                           f"program (p={p_run}) meet the error target")
    sol = optimize(p_run, max(1, prog.stats()["norm2_linprod"]), **kw)
    if sol is None and staged_sol is None:
        raise NoParameters("no parameter set satisfies the error target")
    native_us = (predict_native_us(sol, native_level_boots(prog), batch)
                 if sol is not None else None)
    staged_us = None
    use_staged = False
    if staged_sol is not None:
        staged_us = predict_staged_us(staged_sol, routes, batch)
        native_rt = float("inf") if native_us is None else native_us
        print(f"# runtime model (batch {batch}): native "
              f"{native_rt / 1e3:.1f}ms/eval, staged "
              f"{staged_us / 1e3:.1f}ms/eval", file=sys.stderr)
        use_staged = (staged == "on" or sol is None
                      or staged_us < margin * native_rt)
    if use_staged:
        return Pick(True, (staged_sol.params1, staged_sol.params2), N_LIMBS,
                    staged_sol.p_error, native_us, staged_us)
    return Pick(False, (sol.params,), sol.bsk_limbs, sol.p_error, native_us,
                staged_us)


def predicted_run_s(ex, orients: list[str], bsk_limbs: int,
                    batch: int) -> float | None:
    """The runtime model's ``run_s`` for the executor's plan through the
    kernels ``orients`` (None off the fused kernels)."""
    from ..optimizer.optimizer import Solution, StagedSolution
    from ..optimizer.runtime_model import (predict_native_us,
                                           predict_staged_us)

    if any(o not in ("fused", "fused_otf") for o in orients):
        return None
    if ex.staged:
        ssol = StagedSolution(ex.keys.keys1.params, ex.keys.keys2.params,
                              0.0, 0.0)
        us = predict_staged_us(ssol, ex.plan.level_routes, batch, orients[0])
    else:
        sol = Solution(ex.params, 0.0, 0.0, bsk_limbs)
        us = predict_native_us(sol, [lv.wire_idx.shape[0]
                                     for lv in ex.levels], batch, orients[0])
    return us * batch / 1e6


def mesh_from_arg(spec: str, device: torch.device):
    """The mesh of ``--mesh spec`` on ``device``'s type: "auto" is every
    device of every process (each process's GPUs,
    :func:`..parallel.distributed.local_gpus`; one position a process on the
    CPU), "DP" or "DP,1" DP positions over all processes (on CUDA dealt
    round-robin over each process's GPUs, so DP=2 on one card is two shards
    on it).  Joins the process group first when the environment names one.
    Raises ValueError on a spec it cannot run: not DP[,TP], tp != 1, or a
    DP the processes do not divide."""
    import torch.distributed as dist

    from ..parallel.distributed import (global_mesh, init_distributed,
                                        local_gpus)
    from ..parallel.mesh import check_tp

    world = dist.get_world_size() if init_distributed() else 1
    if spec == "auto":
        return global_mesh(devices=["cpu"] if device.type == "cpu"
                           else None)
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        parts = []
    if len(parts) not in (1, 2) or parts[0] < 1:
        raise ValueError(f"--mesh {spec}: want DP, DP,TP or auto")
    dp, tp = (parts + [1])[:2]
    check_tp(tp)
    if dp % world:
        raise ValueError(f"--mesh {spec}: dp={dp} is not a multiple of the "
                         f"{world} processes")
    per = dp // world
    if device.type == "cpu":
        return global_mesh(devices=["cpu"] * per)
    gpus = local_gpus()
    return global_mesh(devices=[gpus[i % len(gpus)] for i in range(per)])


def family_json(params) -> dict:
    """A family's sizes as the CLI's JSON line names them."""
    return {"p": params.p, "n": params.lwe_dim, "k": params.glwe_dim,
            "N": params.poly_size, "l_bsk": params.bsk_level,
            "b_bsk": params.bsk_base_log, "l_ksk": params.ksk_level,
            "b_ksk": params.ksk_base_log}


def main(argv=None) -> int:
    """The runtime CLI; a process group it joins it also leaves."""
    import torch.distributed as dist

    from ..parallel.distributed import shutdown

    held = dist.is_initialized()      # the caller's group stays
    try:
        return _run(argv)
    finally:
        if not held:
            shutdown()


def _run(argv=None) -> int:
    from ..tfhe.params import PRESETS, STAGED_PRESETS

    ap = argparse.ArgumentParser(
        description="Execute a mapped FBS circuit homomorphically "
                    "(PyTorch / CUDA)")
    ap.add_argument("filename", help=".lbf program or circuit to map")
    ap.add_argument("--map", action="store_true",
                    help="input is a source circuit: map it first")
    ap.add_argument("--type", default="blif",
                    choices=["blif", "bristol", "bench"])
    ap.add_argument("--unroll_frames", type=int, default=10,
                    help="time frames for sequential .bench circuits")
    ap.add_argument("--mapper", default="search",
                    choices=["basic", "naive", "search", "search+",
                             "search+dc", "best"])
    ap.add_argument("--fbs_size", type=int, default=None,
                    help="FBS size of --map (default 4)")
    ap.add_argument("--batch", type=int, default=8,
                    help="number of circuit evaluations in parallel")
    ap.add_argument("--keys", help="key file (.npz, either package's "
                                   "format); generated if absent")
    ap.add_argument("--save-keys", help="write generated keys here")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--checkpoint", default=None,
                    help=".npz path: snapshot the wire buffer and resume an "
                         "interrupted run from it")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="fixed level interval for snapshots (default: "
                         "adaptive, snapshots within ~10%% of the run)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="run the circuit this many times; report the last")
    ap.add_argument("--test-params", action="store_true",
                    help="use the small insecure test parameter set")
    ap.add_argument("--params", choices=sorted(PRESETS)
                    + sorted(STAGED_PRESETS), default=None,
                    help="pin a parameter preset, one family or two staged "
                         "ones, in place of the optimizer's pick")
    ap.add_argument("--p-error", type=float, default=None,
                    help="per-bootstrap error-probability target of the "
                         "parameter optimizer (default: the 4-sigma "
                         "~6.3e-5, at which a run of B bootstraps expects "
                         "~6e-5*B bit flips; e.g. 1e-7 for bit-exact runs)")
    ap.add_argument("--staged", default="auto", choices=["auto", "on", "off"],
                    help="staged two-family pipeline (tfhe/staged.py): large "
                         "tables split into a size-p/2 + size-8 pair, small "
                         "ones run on the select family, wires produced "
                         "pre-scaled.  auto: with the optimizer, staged when "
                         "the program compiles onto it and the runtime "
                         "model prices it cheaper; with --params, as the "
                         "preset says.  on requires it, off refuses it")
    ap.add_argument("--staged-margin", type=float, default=STAGED_MARGIN,
                    help="route staged only when the runtime model's "
                         "prediction beats native by this factor (default "
                         "%(default)s)")
    ap.add_argument("--orientation", default="auto",
                    choices=["auto", "fused", "fused_otf", "generic"],
                    help="bootstrap path of every family (auto: on CUDA the "
                         "fused kernel over precomputed key matrices when "
                         "they fit free device memory, else the compact-key "
                         "kernel, which also runs both staged families, "
                         "and an error if the kernel cannot serve the "
                         "parameters; generic on the CPU)")
    ap.add_argument("--mesh", default=None, metavar="DP[,TP]|auto",
                    help="run the executor mesh-parallel: 'DP' (or 'DP,1') "
                         "positions, or 'auto' (all devices of all "
                         "processes on dp).  dp shards the evaluation batch; "
                         "tp must be 1")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device "
              "cpu to run on the CPU)", file=sys.stderr)
        return 2
    pinned = bool(args.keys or args.test_params or args.params)
    preset_staged = args.params in STAGED_PRESETS
    if args.staged == "on" and pinned and not preset_staged:
        print("--staged on needs the optimizer or a staged --params preset "
              f"(one of {', '.join(sorted(STAGED_PRESETS))})",
              file=sys.stderr)
        return 2
    if args.staged == "off" and preset_staged:
        print(f"--staged off contradicts the staged preset {args.params}",
              file=sys.stderr)
        return 2
    if preset_staged and (args.keys or args.save_keys or args.test_params):
        print("a staged preset generates both families' keys: --keys, "
              "--save-keys and --test-params take one family",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    mesh, dp = None, 1
    if args.mesh:
        try:
            mesh = mesh_from_arg(args.mesh, device)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
        dp = mesh.dp
        if args.batch % dp:
            print(f"--batch {args.batch} must be divisible by dp={dp}",
                  file=sys.stderr)
            return 1
        if args.checkpoint and mesh.spans_processes:
            print("--checkpoint: a mesh that spans processes cannot "
                  "checkpoint", file=sys.stderr)
            return 2
        device = mesh.devices[0]
        print(f"# mesh: dp={dp} tp=1", file=sys.stderr)
    from ..parallel.distributed import (barrier, gather_outputs,
                                        process_index)
    rank = process_index()

    from ..frontend.lut_program import parse_lbf
    from ..frontend.mapping.basic import BasicMapper
    from ..frontend.mapping.heuristic import HeuristicMapper, map_best
    from ..frontend.parsers import parse_circuit
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe import TEST_PARAMS, generate_keys
    from ..tfhe.keys import load_keys, save_keys
    from ..tfhe.staged import generate_staged_keys
    from .executor import CircuitExecutor

    # --- obtain the program --------------------------------------------
    if args.map:
        kw = ({"unroll_frames": args.unroll_frames}
              if args.type == "bench" else {})
        circuit = parse_circuit(args.filename, args.type, **kw)
        p = args.fbs_size or 4
        if args.mapper == "basic":
            prog = BasicMapper().map(circuit)
        elif args.mapper == "best":
            prog = map_best(circuit, fbs_size=p)
        else:
            prog = HeuristicMapper(cone_merger=args.mapper,
                                   fbs_size=p).map(circuit)
        prog.remove_dangling_nodes()
    else:
        with open(args.filename) as f:
            prog = parse_lbf(f.read())

    stats = prog.stats()
    p_needed = prog.fbs_size or prog.min_fbs_size()
    p_run = max(p_needed, args.fbs_size or p_needed)
    print(f"# program: {stats} (p={p_needed})", file=sys.stderr)

    # --- parameters: a pin, or the optimizer's pick ----------------------
    pick = None
    bsk_limbs = N_LIMBS
    p_error = None
    if not pinned:
        try:
            # each device launches its V/dp evaluations
            pick = optimizer_pick(prog, p_run, args.batch // dp, args.staged,
                                  args.p_error, args.staged_margin)
        except NoParameters as e:
            print(e, file=sys.stderr)
            return 1
        bsk_limbs, p_error = pick.bsk_limbs, pick.p_error
    staged = pick.staged if pick is not None else preset_staged

    # --- keys -----------------------------------------------------------
    t0 = time.time()
    if staged:
        if pick is not None:
            fam1, fam2 = pick.families
        else:
            preset = STAGED_PRESETS[args.params]
            if p_run != preset.p:
                print(f"staged preset {args.params} has p={preset.p}, the "
                      f"program p={p_run}", file=sys.stderr)
                return 2
            fam1, fam2, p_error = preset.fam1, preset.fam2, preset.p_error
        print(f"# staged params: fam1={fam1} fam2={fam2}", file=sys.stderr)
        keys = generate_staged_keys(p_run, fam1, fam2, seed=args.seed,
                                    device=device)
        families = [keys.keys1, keys.keys2]
        print(f"# staged keygen: {time.time() - t0:.1f}s", file=sys.stderr)
    elif args.keys:
        keys = load_keys(args.keys, device=device)
        families = [keys]
    else:
        if pick is not None:
            params = pick.families[0]
        elif args.test_params:
            params = TEST_PARAMS.with_p(max(p_needed, TEST_PARAMS.p))
        else:
            params, p_error = PRESETS[args.params]
            if p_run > params.p:
                print(f"preset {args.params} has p={params.p} < the "
                      f"program's p={p_run}", file=sys.stderr)
                return 1
            if p_run != params.p:
                params, p_error = params.with_p(p_run), None
        print(f"# params: {params} (bsk_limbs={bsk_limbs})", file=sys.stderr)
        keys = generate_keys(params, seed=args.seed, device=device)
        families = [keys]
        print(f"# keygen: {time.time() - t0:.1f}s", file=sys.stderr)
        if args.save_keys and rank == 0:
            save_keys(args.save_keys, keys)

    rng = np.random.default_rng(args.seed)
    input_names = [n.name for n in prog.nodes if n.kind == "input"]
    values = {name: rng.integers(0, 2, args.batch) for name in input_names}
    oracle = prog.eval(values)

    # --- bootstrap path of every family, all picked before any fast key
    # is built ------------------------------------------------------------
    fam_params = [k.params for k in families]
    try:
        if args.orientation == "auto":
            # the kernel must fit the fullest device of the mesh
            free = (min(map(free_memory, mesh.distinct))
                    if mesh is not None and device.type == "cuda" else None)
            orients = pick_orientations(fam_params, device, free,
                                        bsk_limbs=bsk_limbs)
        else:
            orients = [args.orientation] * len(families)
            if args.orientation != "generic" and device.type == "cuda":
                for params in fam_params:
                    check_kernel(params, args.orientation)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    fast = None
    if orients[0] != "generic":
        t0 = time.time()
        fast = [prepare_fast_keys(k, orientation=o, bsk_limbs=bsk_limbs)
                for k, o in zip(families, orients)]
        fast = tuple(fast) if staged else fast[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"# fast keys ({'+'.join(orients)}): {time.time() - t0:.1f}s",
              file=sys.stderr)

    ex = CircuitExecutor(prog, keys, fast_keys=fast, mesh=mesh)
    devices = mesh.distinct if mesh is not None else [device]

    def sync():
        if device.type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)
        barrier()

    t0 = time.time()
    buf0 = ex.encrypt_inputs(values, rng)
    enc_s = time.time() - t0
    if device.type == "cuda" and (not args.checkpoint or args.repeat > 1):
        # the graphs a run without a checkpoint replays, captured before
        # the timed window
        t0 = time.time()
        ex.capture(buf0)
        positions = f" x {len(mesh.devices)} positions" if mesh else ""
        print(f"# graphs: {len(ex.groups)} groups{positions} captured in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
    run_s = None
    for i in range(max(1, args.repeat)):
        sync()
        t0 = time.time()
        # checkpointing only applies to the first run: later repeats are
        # steady-state timing and must not resume from its snapshots
        buf = ex.run(buf0, checkpoint=args.checkpoint if i == 0 else None,
                     checkpoint_every=args.checkpoint_every)
        sync()
        run_s = time.time() - t0
    got = gather_outputs(ex.decrypt_outputs(buf))

    errors = wrong_bits = 0
    for k, want in oracle.items():
        bad = int(np.sum(np.asarray(want) != got[k]))
        if bad:
            errors += 1
            wrong_bits += bad
            if rank == 0:
                print(f"MISMATCH on output {k}: want {np.asarray(want)} "
                      f"got {got[k]}", file=sys.stderr)
    if rank != 0:
        return 1 if errors else 0

    total_boots = ex.num_bootstraps * args.batch
    predicted = (predicted_run_s(ex, orients, bsk_limbs, args.batch // dp)
                 if device.type == "cuda" else None)
    print(json.dumps({
        "staged": staged,
        "bit_exact": errors == 0,
        "wrong_bits": wrong_bits,
        "total_output_bits": len(oracle) * args.batch,
        "expected_flips": (round(p_error * total_boots, 3)
                           if p_error is not None else None),
        "outputs": len(oracle),
        "levels": len(ex.levels),
        "bootstraps": ex.num_bootstraps,
        "batch": args.batch,
        "mesh": mesh.shape if mesh is not None else None,
        "orientation": (dict(zip(("fam1", "fam2"), orients)) if staged
                        else orients[0]),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "params_from": ("optimizer" if pick is not None
                        else args.params or ("test" if args.test_params
                                             else "keys")),
        "params": ({"fam1": family_json(fam_params[0]),
                    "fam2": family_json(fam_params[1])} if staged
                   else family_json(fam_params[0])),
        "bsk_limbs": bsk_limbs,
        "p_error": p_error,
        "predicted": ({"native_run_s": _run_s(pick.native_us, args.batch),
                       "staged_run_s": _run_s(pick.staged_us, args.batch)}
                      if pick is not None else None),
        "encrypt_s": round(enc_s, 3),
        "run_s": round(run_s, 3),
        "predicted_run_s": predicted,
        "boots_per_sec": round(total_boots / run_s, 2) if run_s else None,
    }))
    return 1 if errors else 0


def _run_s(us_per_eval: float | None, batch: int) -> float | None:
    return us_per_eval * batch / 1e6 if us_per_eval is not None else None


if __name__ == "__main__":
    sys.exit(main())
