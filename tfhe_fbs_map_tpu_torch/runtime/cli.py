"""Homomorphic circuit runner on PyTorch: execute mapped ``.lbf`` programs.

The counterpart of ``python -m tfhe_fbs_map_tpu.runtime``: load or map a
circuit, generate keys, encrypt random inputs, run every level batched on
the device, decrypt, and check the outputs against ``LutProgram.eval``.
The last line of standard output is the same JSON object.

    python -m tfhe_fbs_map_tpu_torch.runtime prog.lbf --params aes128_p4 --batch 8
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


def pick_orientation(params, device: torch.device,
                     free_bytes: int | None = None) -> str:
    """``--orientation auto``: on CUDA the K2 kernel ("fused") when its
    precomputed key matrices fit free device memory with
    ``FUSED_HEADROOM`` to spare, else K1 ("fused_otf"); generic on the
    CPU.  On CUDA it raises ValueError when neither kernel serves
    ``params``: the plain bootstrap runs there only when asked for."""
    if device.type != "cuda":
        return "generic"
    if unsupported(params, otf=False) is None:
        if free_bytes is None:
            free_bytes, _ = torch.cuda.mem_get_info(device)
        if fused_key_bytes(params) + FUSED_HEADROOM <= free_bytes:
            return "fused"
    check_kernel(params, "fused_otf")
    return "fused_otf"


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
    from ..tfhe.params import PRESETS

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
    ap.add_argument("--params", choices=sorted(PRESETS), default=None,
                    help="pinned parameter preset; stands in for the "
                         "parameter optimizer, which is not ported yet")
    ap.add_argument("--orientation", default="auto",
                    choices=["auto", "fused", "fused_otf", "generic"],
                    help="bootstrap path (auto: on CUDA the fused kernel "
                         "over precomputed key matrices when they fit free "
                         "device memory, else the compact-key kernel, and "
                         "an error if neither serves the parameters; "
                         "generic on the CPU)")
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
    device = torch.device(args.device)

    from ..frontend.lut_program import parse_lbf
    from ..frontend.mapping.basic import BasicMapper
    from ..frontend.mapping.heuristic import HeuristicMapper, map_best
    from ..frontend.parsers import parse_circuit
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe import TEST_PARAMS, generate_keys
    from ..tfhe.keys import load_keys, save_keys
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
    if args.keys:
        keys = load_keys(args.keys, device=device)
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
        t0 = time.time()
        keys = generate_keys(params, seed=args.seed, device=device)
        print(f"# keygen: {time.time() - t0:.1f}s", file=sys.stderr)
        if args.save_keys:
            save_keys(args.save_keys, keys)

    rng = np.random.default_rng(args.seed)
    input_names = [n.name for n in prog.nodes if n.kind == "input"]
    values = {name: rng.integers(0, 2, args.batch) for name in input_names}
    oracle = prog.eval(values)

    # --- bootstrap path ---------------------------------------------------
    orient = args.orientation
    try:
        if orient == "auto":
            orient = pick_orientation(keys.params, device)
        elif orient != "generic" and device.type == "cuda":
            check_kernel(keys.params, orient)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    fast = None
    if orient != "generic":
        t0 = time.time()
        fast = prepare_fast_keys(keys, orientation=orient)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"# fast keys ({orient}): {time.time() - t0:.1f}s",
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
        "staged": False,
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
        "orientation": orient,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "encrypt_s": round(enc_s, 3),
        "run_s": round(run_s, 3),
        "boots_per_sec": round(total_boots / run_s, 2) if run_s else None,
    }))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
