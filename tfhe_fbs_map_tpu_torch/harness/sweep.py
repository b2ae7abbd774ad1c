"""Benchmark sweep: every benchmark of a suite at every FBS size p, each row
priced on the H100.

The port of the JAX package's ``experiments/sweep.py`` (the reference's
``run_benchmarks.sh`` + ``gen_makefile_*.bash`` + ``build_csv.py`` +
``add_exec_estimates.py``), with the same suites, sizes, mappers, resume by
log file and columns:

* the ``generated`` and ``epfl`` suites are regenerated by the port's
  :mod:`..frontend.circuits` into the output directory's ``bench/``; the
  ISCAS85/89 and Bristol files are read from the repo's ``benchmarks/``;
* one mapper process (``python -m tfhe_fbs_map_tpu_torch.frontend.cli``) a
  (bench, p, mapper), ``--jobs`` at a time; a config whose ``.log`` exists
  is skipped, so a cut sweep resumes;
* the stats dict each log ends with goes into ``<suite>_agg.csv``, merged
  with the rows of an earlier aggregate whose logs are gone;
  ``<suite>_agg_est.csv`` adds the cost columns, every one priced by the
  port's parameter search (``optimize`` / ``optimize_staged``, in C++
  where ``g++`` builds :mod:`..optimizer.native`, else in Python: the same
  solutions bit for bit) and :func:`..optimizer.runtime_model.predict_native_us` /
  ``predict_staged_us`` on the calibrated H100 profile
  (``calibration_h100.json``): ``boot_cost`` (µs a bootstrap at a full
  batch), ``total_cost`` (× bootstraps), ``staged_boot_cost`` and
  ``staged_total`` (the staged pipeline where the program realizes it, p ≥
  10 even) and ``native_rt_est`` / ``staged_rt_est`` (µs an evaluation at
  batch :data:`RT_BATCH`, launches and level padding included).  A row is
  priced at the least p its program runs at: a ``basic`` row keeps the
  reference's label p=2, but its AND tables need p=3, where the JAX sweep
  prices p=2, which no run can take.

Everything goes under one output directory, ``--root``/<suite> (default
``outputs/h100/<suite>/``, git-ignored); nothing is written to
``benchmarks/`` or to the JAX sweep's ``outputs/<suite>_agg*.csv``.  The
host needs no pandas and no matplotlib.

Usage::

    python -m tfhe_fbs_map_tpu_torch.harness.sweep --suite iscas85 \\
        --bench c17 --sizes 3,4
"""

from __future__ import annotations

import argparse
import ast
import csv
import functools
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEFAULT_ROOT = REPO / "outputs" / "h100"

SWEEPS = {
    # suite: (fbs sizes for naive+search, include basic baseline)
    "generated": (range(2, 17), True),
    "epfl": (range(3, 17), True),
    "iscas85": (range(2, 33), True),
    "iscas89": (range(2, 33), True),
    "bristol": (range(2, 17), True),
}
SUITE_FORMAT = {"generated": "blif", "epfl": "blif", "iscas85": "bench",
                "iscas89": "bench", "bristol": "bristol"}
# The reference preprocesses ISCAS85 with abc genlib map/unmap into an
# optimized XAG (gen_makefile_iscas85.bash:41); the equivalent here is the
# AIG pass (frontend/opt.py) through the mapping CLI's --opt.
SUITE_OPT = {"iscas85"}
# suites the sweep regenerates into its output directory
REGENERATED = {"generated", "epfl"}
EXTS = {"blif": ".blif", "bench": ".bench", "bristol": ".txt"}
# evaluation batch at which the launch-aware runtime columns are priced (the
# JAX sweep's, the README circuit-table convention)
RT_BATCH = 16
# derived columns: recomputed from the optimizer, never carried over
COST_COLUMNS = ("boot_cost", "total_cost")


def bench_dir(suite: str, out_dir: Path) -> Path:
    """Where a suite's circuit files are: the output directory's ``bench/``
    for a regenerated suite, else the repo's ``benchmarks/<suite>/``."""
    if suite in REGENERATED:
        return out_dir / "bench"
    return REPO / "benchmarks" / suite


def ensure_generated(dest: Path) -> None:
    from ..frontend.circuits import BENCH_GENERATORS, build_bench
    dest.mkdir(parents=True, exist_ok=True)
    for name in BENCH_GENERATORS:
        if name.startswith("trivium_state"):
            continue
        out = dest / f"{name}.blif"
        if out.exists():
            continue
        circ = build_bench(name)
        with open(out, "w") as f:
            circ.to_blif(fs=f, model_name=name)


def ensure_epfl(dest: Path) -> None:
    """The arithmetic and control EPFL members regenerated from their
    functional specs (:data:`..frontend.circuits.EPFL_GENERATORS`)."""
    from ..frontend.circuits import EPFL_GENERATORS
    dest.mkdir(parents=True, exist_ok=True)
    for name, gen in EPFL_GENERATORS.items():
        out = dest / f"{name}.blif"
        if out.exists():
            continue  # previously regenerated files win
        circ = gen()
        circ.remove_dangling_nodes()
        with open(out, "w") as f:
            circ.to_blif(fs=f, model_name=name)


def parse_sizes(spec: str) -> list[int]:
    """``2-8`` or ``3,5,9``."""
    if "-" in spec:
        lo, hi = spec.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(x) for x in spec.split(",")]


def configs_for(suite: str, bench_files: list[Path], out_dir: Path,
                timeout: float = 3600, mappers: list[str] | None = None,
                sizes=None):
    """(bench, format, p, mapper, log, timeout, opt) a config: the basic
    baseline at p=2 (unless ``mappers`` is given), then each size (default
    the suite's) with each of the suite's mappers."""
    default_sizes, with_basic = SWEEPS[suite]
    sizes = default_sizes if sizes is None else sizes
    fmt = SUITE_FORMAT[suite]
    opt = suite in SUITE_OPT
    for bench in bench_files:
        stem = bench.stem
        if with_basic and not mappers:
            yield (bench, fmt, 2, "basic",
                   out_dir / f"{stem}_2_basic.log", timeout, opt)
        for p in sizes:
            for mapper in mappers or (("naive", "search") if suite == "epfl"
                                      else ("search",)):
                yield (bench, fmt, p, mapper,
                       out_dir / f"{stem}_{p}_{mapper}.log", timeout, opt)


def run_one(cfg) -> str:
    """Map one config through the port's mapping CLI into its log (stats
    line last), ``.fbs`` and ``.lbf``; skipped when the log exists."""
    bench, fmt, p, mapper, log, timeout, opt = cfg
    if log.exists():
        return f"skip {log.name}"
    cmd = [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.frontend.cli",
           str(bench), "--type", fmt, "--fbs_size", str(p),
           "--mapper", mapper,
           "--output", str(log.with_suffix(".fbs")),
           "--output_lbf", str(log.with_suffix(".lbf"))]
    if opt:
        cmd.append("--opt")
    with open(log, "w") as f:
        try:
            subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                           cwd=str(REPO), timeout=timeout)
        except subprocess.TimeoutExpired:
            # leave the partial log (aggregate() skips unparseable logs,
            # as the reference's build_csv.py does) and go on
            f.write(f"\n# TIMEOUT after {timeout}s\n")
            return f"timeout {log.name}"
    return f"done {log.name}"


def _cell(text: str):
    """A CSV cell as the type it was written from: bool, int, float or
    str."""
    if text in ("True", "False"):
        return text == "True"
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return text


def read_rows(csv_path: Path) -> list[dict]:
    """An aggregate's rows, each cell typed, empty cells left out."""
    with open(csv_path, newline="") as f:
        return [{k: _cell(v) for k, v in r.items() if v != ""}
                for r in csv.DictReader(f)]


def write_rows(rows: list[dict], csv_path: Path) -> None:
    keys = sorted({k for r in rows for k in r})
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(rows)


def aggregate(out_dir: Path, csv_path: Path) -> list[dict]:
    """The stats line of every log in ``out_dir`` as a row, merged with the
    rows of an existing ``csv_path`` whose logs are gone (fresh logs win on
    (bench, mapper, fbs_size); an old row's cost columns are dropped, to be
    priced again), written to ``csv_path``."""
    rows = []
    for log in sorted(out_dir.glob("*.log")):
        try:
            d = ast.literal_eval(log.read_text().strip().splitlines()[-1])
            d["bench"] = Path(d["filename"]).stem
            rows.append(d)
        except (ValueError, SyntaxError, TypeError, KeyError,
                IndexError) as e:  # a failed run, as build_csv.py:28 skips
            print(f"cannot parse {log}: {e}", file=sys.stderr)
    if csv_path.exists():
        have = {(r["bench"], r["mapper"], int(r["fbs_size"])) for r in rows}
        for r in read_rows(csv_path):
            if (r["bench"], r["mapper"], int(r["fbs_size"])) not in have:
                rows.append({k: v for k, v in r.items()
                             if v == v and k not in COST_COLUMNS})
    rows.sort(key=lambda d: (d["bench"], d["mapper"], d["fbs_size"]))
    if rows:
        write_rows(rows, csv_path)
    return rows


def searches(native: bool = True, profile=None) -> tuple:
    """The port's ``optimize`` and ``optimize_staged`` on ``profile``
    (default the H100's): in C++ (:mod:`..optimizer.native`, built with
    ``g++`` at first use) or in Python; they return the same
    solutions (``tests/test_torch_native_optimizer.py``)."""
    if native:
        from ..optimizer.native import optimize_native as opt
        from ..optimizer.native import optimize_staged_native as opt_staged
    else:
        from ..optimizer import optimize as opt
        from ..optimizer import optimize_staged as opt_staged
    return (functools.partial(opt, profile=profile),
            functools.partial(opt_staged, profile=profile))


def staged_estimates(prog, p: int, p_error: float | None = None,
                     search=None) -> tuple[float, float] | None:
    """(whole-program staged cost, µs an evaluation at RT_BATCH) of the
    staged families :func:`..runtime.cli.staged_solution` picks with the
    staged ``search`` (default the Python one), or None where it picks
    none; raises ValueError when ``prog`` is not staged-realizable."""
    from ..optimizer.runtime_model import predict_staged_us
    from ..runtime.cli import staged_solution
    from ..runtime.executor import staged_level_routes
    ssol = staged_solution(prog, p, p_error, search)
    if ssol is None:
        return None
    return ssol.cost, predict_staged_us(ssol, staged_level_routes(prog, p),
                                        RT_BATCH)


def _program(row: dict):
    """The row's mapped program, or None where its ``.lbf`` is gone or
    unreadable."""
    from ..frontend.lut_program import parse_lbf
    lbf = Path(str(row.get("output_lbf", "")))
    if not lbf.is_file():
        return None
    try:
        return parse_lbf(lbf.read_text())
    except (ValueError, KeyError, IndexError):
        return None


def add_estimates(rows: list[dict], csv_path: Path, profile=None,
                  p_error: float | None = None,
                  native: bool | None = None) -> None:
    """The cost columns of each row, written with the rows to
    ``csv_path``.  ``total_cost`` and ``staged_total`` keep the reference's
    per-bootstrap estimate; the ``*_rt_est`` columns price the launches and
    the power-of-two level padding on top, the numbers the runtime CLI
    routes staged against native on.  A row is priced at the least p its
    program runs at (its label where the ``.lbf`` is gone).  ``profile``
    (default the H100's) and ``p_error`` (default the search's 4-sigma
    target) go to the searches (:func:`searches`; ``native`` default:
    where the C++ library builds); the ``*_rt_est`` columns are the H100
    runtime model's."""
    from ..optimizer.native import native_available
    from ..optimizer.runtime_model import predict_native_us
    from ..runtime.executor import native_level_boots
    if native is None:
        native = native_available()
    optimize, optimize_staged = searches(native, profile)
    kw = {} if p_error is None else {"max_p_error": p_error}
    memo: dict[tuple, object] = {}
    for r in rows:
        prog = _program(r)
        p = int(r["fbs_size"])
        if prog is not None:
            p = max(p, prog.min_fbs_size())
        key = (p, r["norm2_linprod"])
        if key not in memo:
            memo[key] = optimize(p, float(key[1]), **kw)
        sol = memo[key]
        r["boot_cost"] = round(sol.cost, 1) if sol else float("nan")
        nb = r.get("nb_bootstrap", 0)
        r["total_cost"] = round(nb * sol.cost, 1) if sol else float("nan")
        r["staged_boot_cost"] = r["staged_total"] = ""
        r["native_rt_est"] = r["staged_rt_est"] = ""
        if prog is None:
            continue
        n_boots = max(1, prog.stats()["nb_bootstrap"])
        if sol is not None:
            r["native_rt_est"] = round(predict_native_us(
                sol, native_level_boots(prog), RT_BATCH), 1)
        if p >= 10 and p % 2 == 0:
            try:
                st = staged_estimates(prog, p, p_error, optimize_staged)
            except (ValueError, AssertionError):
                continue        # not staged-realizable: native only
            if st is not None:
                r["staged_total"] = round(st[0], 1)
                r["staged_boot_cost"] = round(st[0] / n_boots, 1)
                r["staged_rt_est"] = round(st[1], 1)
    write_rows(rows, csv_path)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="generated", choices=list(SWEEPS))
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=3600,
                    help="per-config mapper budget (s); slower configs are "
                         "logged as timeouts and skipped by aggregation")
    ap.add_argument("--root", default=str(DEFAULT_ROOT),
                    help="write under ROOT/<suite>/ (default "
                         "outputs/h100, git-ignored)")
    ap.add_argument("--bench", nargs="*", default=None,
                    help="restrict to these benchmark stems")
    ap.add_argument("--sizes", default=None,
                    help="fbs sizes, e.g. 2-8 or 3,5,9")
    ap.add_argument("--mappers", nargs="*", default=None,
                    help="override the suite's mapper list (e.g. 'best'); "
                         "rows merge into the same aggregate, keyed by the "
                         "mapper column")
    args = ap.parse_args(argv)

    out_dir = Path(args.root) / args.suite
    out_dir.mkdir(parents=True, exist_ok=True)
    src = bench_dir(args.suite, out_dir)
    if args.suite == "generated":
        ensure_generated(src)
    if args.suite == "epfl":
        ensure_epfl(src)
    if not src.exists():
        print(f"no benchmarks at {src}", file=sys.stderr)
        return 1

    bench_files = sorted(src.glob(f"*{EXTS[SUITE_FORMAT[args.suite]]}"))
    if args.bench:
        bench_files = [b for b in bench_files if b.stem in args.bench]
    cfgs = list(configs_for(args.suite, bench_files, out_dir, args.timeout,
                            args.mappers,
                            parse_sizes(args.sizes) if args.sizes else None))
    print(f"{len(cfgs)} configs over {len(bench_files)} benchmarks")

    # each worker only waits on its mapper process
    with ThreadPoolExecutor(args.jobs) as pool:
        for fut in as_completed([pool.submit(run_one, c) for c in cfgs]):
            print(fut.result())

    rows = aggregate(out_dir, out_dir / f"{args.suite}_agg.csv")
    from ..optimizer.native import native_available
    native = native_available()
    t0 = time.perf_counter()
    add_estimates(rows, out_dir / f"{args.suite}_agg_est.csv",
                  native=native)
    print(f"priced {len(rows)} rows in {time.perf_counter() - t0:.3f} s "
          f"({'native search' if native else 'python search: no g++'})")
    print(f"aggregated {len(rows)} rows into "
          f"{out_dir / f'{args.suite}_agg_est.csv'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
