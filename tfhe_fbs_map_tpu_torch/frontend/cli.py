"""Command-line entry point: map a Boolean circuit to an FBS program.

Drop-in equivalent of the reference CLI
(``fbs_mapper/map_circuit.py:92-188``): parse → evaluate the
source on 1000 random vectors (seed 42) → map (timed) → DCE → print the stats
dict merged with the arguments as the last line (the experiment harness
parses exactly that) → assert per-output bit-exact equality of the mapped
program → write ``.fbs`` / ``.lbf`` outputs.

Run as ``python -m tfhe_fbs_map_tpu_torch.frontend.cli circuit.blif
[options]``.  The port's copy of ``tfhe_fbs_map_tpu.frontend.cli``: the
same arguments, stats line, exit codes and output bytes
(``tests/test_torch_frontend_cli.py``).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
import traceback

import numpy as np

from .mapping.basic import BasicMapper
from .mapping.heuristic import HeuristicMapper
from .parsers import parse_circuit

__all__ = ["main", "build_arg_parser"]


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Map logic gates to functional bootstrapping (FBS)")
    p.add_argument("filename", help="input circuit")
    p.add_argument("--type", choices=["blif", "bristol", "bench"],
                   default="blif", help="input format")
    p.add_argument("--fbs_size", default=3, type=int, help="FBS size")
    p.add_argument("--mapper",
                   choices=["basic", "naive", "search", "search+", "search+dc",
                            "best"],
                   default="search",
                   help="mapping strategy (search = reference-parity "
                        "heuristic; search+ = trial-repair variant; best = "
                        "race both, keep the cheaper program)")
    p.add_argument("--strict_fbs_size", action="store_true",
                   help="do not use the anti-cyclic ring property")
    p.add_argument("--output", help="output mapped circuit file (.fbs)")
    p.add_argument("--output_lbf", help="output mapped circuit file (.lbf)")
    p.add_argument("--max_tt_size", default=16, type=int,
                   help="maximal truth table size (log2) before bootstrapping")
    p.add_argument("--unroll_frames", default=10, type=int,
                   help="time frames for sequential .bench circuits")
    p.add_argument("--opt", action="store_true",
                   help="AIG logic optimization before mapping (strash + "
                        "XOR recollapse — the role of the reference's abc "
                        "genlib map/unmap step, gen_makefile_iscas85.bash:41)")
    p.add_argument("--verbose", "-v", action="count", default=0)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_arg_parser().parse_args(argv)

    levels = [logging.CRITICAL, logging.ERROR, logging.WARNING,
              logging.INFO, logging.DEBUG]
    logging.basicConfig(level=levels[min(args.verbose, len(levels) - 1)])

    max_fbs_size = args.fbs_size if args.strict_fbs_size else 2 * args.fbs_size
    args.max_fbs_size = max_fbs_size

    if args.mapper == "basic":
        mapper = BasicMapper()
    elif args.mapper == "best":
        from .mapping.heuristic import map_best

        class mapper:  # noqa: N801 — duck-typed .map()
            @staticmethod
            def map(circ):
                return map_best(circ, fbs_size=args.fbs_size,
                                max_fbs_size=max_fbs_size,
                                max_truth_table_size=args.max_tt_size)
    else:
        mapper = HeuristicMapper(
            cone_merger=args.mapper,
            fbs_size=args.fbs_size,
            max_fbs_size=max_fbs_size,
            max_truth_table_size=args.max_tt_size)

    kw = {"unroll_frames": args.unroll_frames} if args.type == "bench" else {}
    try:
        circuit = parse_circuit(args.filename, args.type, **kw)
    except FileNotFoundError:
        print(f"error: input circuit not found: {args.filename}",
              file=sys.stderr)
        return 2

    if args.opt:
        from .opt import optimize
        before = circuit.stats()
        circuit = optimize(circuit)
        after = circuit.stats()
        logging.info("opt: %d -> %d 2-input gates (%d xor)",
                     before["nb_and"] + before["nb_xor"] + before["nb_lut"],
                     after["nb_and"] + after["nb_xor"] + after["nb_lut"],
                     after["nb_xor"])

    np.random.seed(42)
    input_vals = {inp.name: np.random.randint(0, 2, 1000)
                  for inp in circuit.inputs}
    source_out = circuit.eval(input_vals)

    start = time.time()
    try:
        prog = mapper.map(circuit)
    except Exception:
        logging.critical(traceback.format_exc())
        return 0  # clean exit so harness sweeps continue (ref behavior)
    prog.remove_dangling_nodes()
    duration = time.time() - start

    stats = prog.stats()
    stats.update(args.__dict__)
    stats["time"] = duration
    print(stats)

    mapped_out = prog.eval(input_vals)
    assert source_out.keys() == mapped_out.keys()
    for k in source_out:
        if not np.all(source_out[k] == mapped_out[k]):
            print(f"output {k} does not match: "
                  f"{source_out[k]} {mapped_out[k]}")
            raise AssertionError(f"output {k} mismatch")

    if args.output is not None:
        with open(args.output, "w") as f:
            prog.print(show_outputs=True, os=f)
    if args.output_lbf is not None:
        with open(args.output_lbf, "w") as f:
            prog.write_lbf(os=f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
