"""Recompute the staged columns of the sweep's aggregates on the H100.

The port of the JAX package's ``experiments/reestimate_staged.py``: re-maps
exactly the configs of ``<root>/<suite>/<suite>_agg_est.csv`` that have a
``staged_total`` value where their ``.lbf`` is gone (the sweep's per-config
files are regenerable and routinely pruned), probes them again, and
rewrites ``staged_boot_cost`` / ``staged_total`` / ``staged_rt_est``
through the sweep's staged estimate (:func:`.sweep.staged_estimates`, the
runtime CLI's ``staged_solution``).  A config whose re-map fails keeps
its old estimate; only a program the staged pipeline cannot realize clears
it.

Usage::

    python -m tfhe_fbs_map_tpu_torch.harness.reestimate_staged \\
        [--suite iscas85 ...] [--jobs 2] [--root outputs/h100]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .sweep import (DEFAULT_ROOT, EXTS, REPO, SUITE_FORMAT, SUITE_OPT, SWEEPS,
                    bench_dir, read_rows, staged_estimates, write_rows)


def _map_one(args) -> tuple[str, bool]:
    """Re-map one (suite, bench, p, mapper) config; returns (lbf, ok).

    ``ok`` is False on a failure of the mapper process (non-zero exit,
    timeout): the caller then leaves the row's old estimate in place, so a
    flaky run never erases an estimate."""
    suite, bench_file, p, mapper, lbf = args
    if Path(lbf).is_file():
        return lbf, True
    cmd = [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.frontend.cli",
           str(bench_file), "--type", SUITE_FORMAT[suite],
           "--fbs_size", str(p), "--mapper", mapper,
           "--output_lbf", str(lbf)]
    if suite in SUITE_OPT:
        cmd.append("--opt")
    try:
        r = subprocess.run(cmd, capture_output=True, cwd=str(REPO),
                           timeout=3600)
    except subprocess.TimeoutExpired:
        print(f"MAP TIMEOUT {bench_file} p={p} {mapper}", file=sys.stderr)
        return lbf, False
    if r.returncode != 0:
        print(f"MAP FAILED {bench_file} p={p} {mapper}: "
              f"{r.stderr.decode()[-200:]}", file=sys.stderr)
        return lbf, False
    return lbf, True


def reestimate(suite: str, root: Path, jobs: int) -> None:
    from ..frontend.lut_program import parse_lbf

    out_dir = root / suite
    csv_path = out_dir / f"{suite}_agg_est.csv"
    rows = read_rows(csv_path)
    todo = [r for r in rows if r.get("staged_total", "") != ""]
    if not todo:
        print(f"{suite}: no staged rows")
        return
    src = bench_dir(suite, out_dir)
    jobs_args = []
    for r in todo:
        bench_file = src / f"{r['bench']}{EXTS[SUITE_FORMAT[suite]]}"
        if not bench_file.is_file():
            print(f"{suite}: no circuit file for {r['bench']}, skipping",
                  file=sys.stderr)
            continue
        lbf = out_dir / f"{r['bench']}_{r['fbs_size']}_{r['mapper']}.lbf"
        jobs_args.append((suite, bench_file, int(r["fbs_size"]),
                          r["mapper"], str(lbf)))
    with ThreadPoolExecutor(jobs) as pool:
        ok_lbf = dict(pool.map(_map_one, jobs_args))

    changed = cleared = kept = 0
    for r in todo:
        p = int(r["fbs_size"])
        lbf = out_dir / f"{r['bench']}_{r['fbs_size']}_{r['mapper']}.lbf"
        old = r["staged_total"]
        # a failed re-map or a missing circuit file keeps the old estimate:
        # only real staged-infeasibility (ValueError below) clears it
        if not lbf.is_file() or not ok_lbf.get(str(lbf), True):
            kept += 1
            continue
        try:
            prog = parse_lbf(lbf.read_text())
            nb = prog.stats()["nb_bootstrap"]
            if nb != r.get("nb_bootstrap", nb):
                # the re-map differs: refresh the row's native columns from
                # it, so the row never mixes two mappings
                print(f"{suite}: {r['bench']} p={p} {r['mapper']} remap "
                      f"boots {nb} != CSV {r['nb_bootstrap']} (row "
                      f"refreshed from remap)", file=sys.stderr)
                st = prog.stats()
                r["nb_bootstrap"] = st["nb_bootstrap"]
                r["norm2_linprod"] = st["norm2_linprod"]
                r["max_lut_size"] = st["max_lut_size"]
                bc = r.get("boot_cost", float("nan"))
                if isinstance(bc, float) and bc == bc:
                    r["total_cost"] = round(nb * bc, 1)
            r["staged_boot_cost"] = r["staged_total"] = ""
            r["staged_rt_est"] = ""
            est = staged_estimates(prog, p)
            if est is not None:
                r["staged_total"] = round(est[0], 1)
                r["staged_boot_cost"] = round(est[0] / max(1, nb), 1)
                r["staged_rt_est"] = round(est[1], 1)
                if r["staged_total"] != old:
                    changed += 1
            else:
                cleared += 1
        except (ValueError, AssertionError):
            r["staged_boot_cost"] = r["staged_total"] = ""
            r["staged_rt_est"] = ""
            cleared += 1           # not staged-realizable
    write_rows(rows, csv_path)
    print(f"{suite}: {len(todo)} staged rows -> {changed} changed, "
          f"{cleared} cleared (not staged-realizable), {kept} kept "
          f"(re-map failed)")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", nargs="*", default=list(SWEEPS))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--root", default=str(DEFAULT_ROOT),
                    help="the sweep's root: ROOT/<suite>/<suite>_agg_est.csv")
    args = ap.parse_args(argv)
    for s in args.suite:
        if (Path(args.root) / s / f"{s}_agg_est.csv").is_file():
            reestimate(s, Path(args.root), args.jobs)
        else:
            print(f"{s}: no aggregate under {args.root}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
