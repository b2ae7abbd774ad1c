"""Homomorphic circuit runner on PyTorch: execute mapped ``.lbf`` programs.

The counterpart of ``python -m tfhe_fbs_map_tpu.runtime``: load or map a
circuit, generate keys, encrypt random inputs, run every level batched on
the device, decrypt, and check the outputs against ``LutProgram.eval``.
The last line of standard output is the same JSON object.  A staged preset
(``--params kreyvium_p10_staged``, ``p32_staged``) runs the staged
two-family pipeline.

    python -m tfhe_fbs_map_tpu_torch.runtime prog.lbf --params aes128_p4 --batch 8
    python -m tfhe_fbs_map_tpu_torch.runtime \\
        outputs/generated/kreyvium_stream_v1_10_search.lbf \\
        --params kreyvium_p10_staged --batch 16 --orientation fused_otf
    python -m tfhe_fbs_map_tpu_torch.runtime c.blif --map --test-params --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.blind_rotate import fused_key_bytes
from ..ops.fused_blind_rotate import unsupported

# Device memory left free beside the "fused" key matrices when --orientation
# auto picks them: room for the wire buffer and one level's temporaries.
FUSED_HEADROOM = 4 << 30


def pick_orientations(families, device: torch.device,
                      free_bytes: int | None = None) -> list[str]:
    """``--orientation auto`` for the parameter families of one run: generic
    on the CPU.  On CUDA, one family goes to the K2 kernel ("fused") when
    K2 serves it and its precomputed key matrices fit free device memory
    with ``FUSED_HEADROOM`` to spare, else to K1 ("fused_otf").  The two
    staged families both go to K1, the JAX reference's choice at every
    staged preset: their K2 matrices take 59-67 GB, and on the Kreyvium
    preset K1 ran the whole path faster even before K2's matrices are
    built (PERF.md); ``--orientation fused`` still asks for K2.  On
    CUDA it raises ValueError when the kernel picked cannot serve a family:
    the plain bootstrap runs there only when asked for."""
    if device.type != "cuda":
        return ["generic"] * len(families)
    if len(families) == 1 and unsupported(families[0], otf=False) is None:
        if free_bytes is None:
            free_bytes, _ = torch.cuda.mem_get_info(device)
        if fused_key_bytes(families[0]) + FUSED_HEADROOM <= free_bytes:
            return ["fused"]
    for p in families:
        check_kernel(p, "fused_otf")
    return ["fused_otf"] * len(families)


def check_kernel(params, orientation: str) -> None:
    """Raise ValueError when the CUDA kernel of ``orientation`` cannot
    serve ``params``."""
    why = unsupported(params, otf=orientation == "fused_otf")
    if why is not None:
        raise ValueError(
            f"no fused CUDA kernel ({orientation}) serves these parameters: "
            f"{why}; pass --orientation generic to run the plain PyTorch "
            f"bootstrap on the card")


def main(argv=None) -> int:
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
                    help="pinned parameter preset, one family or two staged "
                         "ones; stands in for the parameter optimizer, "
                         "which is not ported yet")
    ap.add_argument("--staged", default="auto", choices=["auto", "on", "off"],
                    help="staged two-family pipeline (tfhe/staged.py): large "
                         "tables split into a size-p/2 + size-8 pair, small "
                         "ones run on the select family, wires produced "
                         "pre-scaled.  Until the optimizer is ported it "
                         "follows --params: auto runs staged exactly when "
                         "the preset is a staged one, on requires one, off "
                         "refuses one")
    ap.add_argument("--orientation", default="auto",
                    choices=["auto", "fused", "fused_otf", "generic"],
                    help="bootstrap path of every family (auto: on CUDA the "
                         "fused kernel over precomputed key matrices when "
                         "they fit free device memory, else the compact-key "
                         "kernel, which also runs both staged families, "
                         "and an error if the kernel cannot serve the "
                         "parameters; generic on the CPU)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (use --device "
              "cpu to run on the CPU)", file=sys.stderr)
        return 2
    if not (args.keys or args.test_params or args.params):
        print("pass --params <preset>, --test-params or --keys: the "
              "parameter optimizer is not ported yet", file=sys.stderr)
        return 2
    staged = args.params in STAGED_PRESETS
    if args.staged == "on" and not staged:
        print("--staged on needs a staged --params preset (one of "
              f"{', '.join(sorted(STAGED_PRESETS))})", file=sys.stderr)
        return 2
    if args.staged == "off" and staged:
        print(f"--staged off contradicts the staged preset {args.params}",
              file=sys.stderr)
        return 2
    if staged and (args.keys or args.save_keys or args.test_params):
        print("a staged preset generates both families' keys: --keys, "
              "--save-keys and --test-params take one family",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)

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

    # --- keys -----------------------------------------------------------
    p_error = None
    t0 = time.time()
    if staged:
        preset = STAGED_PRESETS[args.params]
        if p_run != preset.p:
            print(f"staged preset {args.params} has p={preset.p}, the "
                  f"program p={p_run}", file=sys.stderr)
            return 2
        print(f"# staged params: fam1={preset.fam1} fam2={preset.fam2}",
              file=sys.stderr)
        keys = generate_staged_keys(preset.p, preset.fam1, preset.fam2,
                                    seed=args.seed, device=device)
        families = [keys.keys1, keys.keys2]
        p_error = preset.p_error
        print(f"# staged keygen: {time.time() - t0:.1f}s", file=sys.stderr)
    elif args.keys:
        keys = load_keys(args.keys, device=device)
        families = [keys]
    else:
        if args.test_params:
            params = TEST_PARAMS.with_p(max(p_needed, TEST_PARAMS.p))
        else:
            params, p_error = PRESETS[args.params]
            if p_run > params.p:
                print(f"preset {args.params} has p={params.p} < the "
                      f"program's p={p_run}", file=sys.stderr)
                return 1
            if p_run != params.p:
                params, p_error = params.with_p(p_run), None
            print(f"# params: {params}", file=sys.stderr)
        keys = generate_keys(params, seed=args.seed, device=device)
        families = [keys]
        print(f"# keygen: {time.time() - t0:.1f}s", file=sys.stderr)
        if args.save_keys:
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
            orients = pick_orientations(fam_params, device)
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
        fast = [prepare_fast_keys(k, orientation=o)
                for k, o in zip(families, orients)]
        fast = tuple(fast) if staged else fast[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"# fast keys ({'+'.join(orients)}): {time.time() - t0:.1f}s",
              file=sys.stderr)

    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    t0 = time.time()
    buf0 = ex.encrypt_inputs(values, rng)
    enc_s = time.time() - t0
    run_s = None
    for rep in range(max(1, args.repeat)):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        # checkpointing only applies to the first run: later repeats are
        # steady-state timing and must not resume from its snapshots
        buf = ex.run(buf0, checkpoint=args.checkpoint if rep == 0 else None,
                     checkpoint_every=args.checkpoint_every)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run_s = time.time() - t0
    got = ex.decrypt_outputs(buf)

    errors = wrong_bits = 0
    for k, want in oracle.items():
        bad = int(np.sum(np.asarray(want) != got[k]))
        if bad:
            errors += 1
            wrong_bits += bad
            print(f"MISMATCH on output {k}: want {np.asarray(want)} "
                  f"got {got[k]}", file=sys.stderr)

    total_boots = ex.num_bootstraps * args.batch
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
        "mesh": None,
        "orientation": (dict(zip(("fam1", "fam2"), orients)) if staged
                        else orients[0]),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "encrypt_s": round(enc_s, 3),
        "run_s": round(run_s, 3),
        "boots_per_sec": round(total_boots / run_s, 2) if run_s else None,
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
