"""The benchmark of the PyTorch and CUDA port on NVIDIA H100 cards.

    python3 bench_h100/run.py --workload aes128_p4.b8 --seed 7 --seconds 10 \\
        --trace 0

Runs one cell of ``BENCHMARK.json`` (``harness/cell.py``): set-up, a window
of ``--seconds`` of batches, every evaluation judged by the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` evaluations, the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics read from a profiler trace of the
window (``--trace 1``, with ``breakdown``), ``device``, and last
``compared``, each number of the comparison beside its limit (also the last
lines of standard error).  Without as many CUDA devices as the cell asks
for it exits 2 and prints no result; with the JAX package or JAX loaded
after the window, 3.
"""

import time

T_START = time.time()

import argparse                                           # noqa: E402
import json                                               # noqa: E402
import sys                                                # noqa: E402
from pathlib import Path                                  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# top-level module names that no process of the benchmark may load
FOREIGN = ("jax", "jaxlib", "flax", "tfhe_fbs_map_tpu")


def foreign_modules() -> list[str]:
    """The forbidden top-level names in ``sys.modules`` (names compared
    whole: ``tfhe_fbs_map_tpu_torch`` is not ``tfhe_fbs_map_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FOREIGN))


def result_line(run, bench: dict, trace: bool) -> dict:
    """The contract's last line of a finished run."""
    import torch

    from bench_h100.harness.cell import is_correct
    from bench_h100.harness.spec import cell_metrics, metric_reader

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, run.cell.name, kind):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.dp, "memory_peak_bytes": run.memory_peak_bytes}
    line = {"correct": is_correct(run), "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        tr = run.trace
        devs = tr.devices()
        device["busy_s"] = (sum(tr.busy_s(d) for d in devs) / len(devs)
                            if devs else 0.0)
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line["compared"] = run.compared
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100.harness.cell import run_cell
    from bench_h100.harness.spec import load_benchmark, load_cell

    bench = load_benchmark()
    cell = load_cell(args.workload, bench)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s), this machine "
              f"has {have}: no result", file=sys.stderr)
        return 2
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   [f"cuda:{i}" for i in range(cell.chips)], T_START)
    foreign = foreign_modules()
    if foreign:
        print(f"loaded {', '.join(foreign)}: the benchmark runs the port "
              f"alone; no result", file=sys.stderr)
        return 3
    print(f"# batches {len(run.times)}, seconds "
          f"{' '.join(f'{t:.4f}' for t in run.times)}; setup_s "
          f"{run.setup_s:.3f}; memory_peak_bytes {run.memory_peak_bytes}",
          file=sys.stderr)
    line = result_line(run, bench, bool(args.trace))
    print(json.dumps(line), flush=True)
    for name, c in run.compared.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
