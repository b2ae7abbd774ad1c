"""The readings that the comparison's limits are set from: sound runs of a
cell on many seeds, and its control, the program with its bootstrapping key
one limb short of the configuration's (the nearest precision below the one
it states), on a few, all in one process.

    python3 bench_h100/control.py --workload aes128_p4.b8 \\
        --seeds 101,102,103 --control-seeds 201,202 --seconds 0

Each run sets the cell up anew with its seed and measures one batch (or as
many as ``--seconds`` take); one JSON line a run, then a summary: the
largest sound reading of each compared number and the smallest control
reading.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness.cell import run_cell
    from bench_h100.harness.spec import load_cell

    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    limbs = cell.config["bsk_limbs"]
    plan = [(int(s), limbs, "sound") for s in args.seeds.split(",") if s] \
        + [(int(s), limbs - 1, "control")
           for s in args.control_seeds.split(",") if s]
    worst = {"sound": {}, "control": {}}
    for seed, n_limbs, kind in plan:
        run = run_cell(cell, seed, args.seconds, False, devices,
                       bsk_limbs=n_limbs)
        values = {k: c["value"] for k, c in run.compared.items()}
        print(json.dumps({"kind": kind, "seed": seed, "limbs": n_limbs,
                          "evaluations": run.attempted,
                          "failed": run.failed, "seconds": run.times,
                          **values}), flush=True)
        pick = max if kind == "sound" else min
        for k, v in values.items():
            worst[kind][k] = pick(worst[kind].get(k, v), v)
        del run
    print(json.dumps({"workload": cell.name, "sound_max": worst["sound"],
                      "control_min": worst["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
