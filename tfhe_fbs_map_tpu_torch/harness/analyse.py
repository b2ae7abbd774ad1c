"""Results analysis over the H100 sweep: tables and comparison constants.

The port of the JAX package's ``experiments/analyse.py`` (the reference's
``analyse_results.py``, C21): per-benchmark best-cost summaries
(``total_cost = nb_bootstrap × boot_cost``), map-time statistics, and the
published comparison constants from the AutoHoG and Bon et al. papers
(hardcoded in the reference at ``analyse_results.py: 171-183, 215-244,
342-353``), over the aggregates :mod:`.sweep` writes, whose costs are the
H100's.  The measured-runs table reads the port's runtime CLI's JSON lines
and prints the device each ran on.  Emits markdown instead of raw LaTeX;
pass ``--latex`` for LaTeX rows.  ``--plots`` needs matplotlib, imported
only then.

Usage::

    python -m tfhe_fbs_map_tpu_torch.harness.analyse \
        outputs/h100/iscas85/iscas85_agg_est.csv --measured outputs/h100/runs
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from collections import defaultdict
from pathlib import Path

from .sweep import DEFAULT_ROOT

# AutoHoG paper comparison constants (TFHE CPU eval seconds:
# baseline / AutoHoG), reference analyse_results.py:171-183
AUTOHOG_ISCAS85 = {
    "c17": (0.1, 0.04), "c432": (3.0, 1.39), "c1355": (8.99, 1.49),
    "c3540": (21.82, 5.6), "c7552": (45.81, 8.06),
}

# AutoHoG paper Table IV (ISCAS89; TFHE-baseline / AutoHoG seconds),
# reference analyse_results.py:215-244 — 27 circuits
AUTOHOG_ISCAS89 = {
    "s27": (0.14, 0.11), "s298": (2.06, 0.60), "s344": (1.77, 0.58),
    "s349": (1.87, 0.67), "s382": (2.50, 0.56), "s386": (3.16, 0.54),
    "s400": (2.60, 0.55), "s420": (2.76, 0.94), "s444": (2.84, 0.60),
    "s510": (3.50, 1.02), "s526": (4.32, 1.03), "s641": (2.67, 1.25),
    "s713": (3.40, 1.39), "s820": (7.12, 1.50), "s832": (7.71, 1.61),
    "s838": (5.68, 1.89), "s953": (5.93, 1.69), "s1196": (6.44, 1.55),
    "s1238": (6.62, 1.81), "s1423": (8.40, 2.79), "s1488": (12.66, 1.70),
    "s5378": (23.15, 3.15), "s9234": (40.25, 11.18),
    "s13207": (53.28, 22.84), "s15850": (66.71, 30.11),
    "s35932": (209.56, 65.69), "s38584": (231.75, 92.21),
}

# Bon et al. comparison targets (generated suite),
# reference analyse_results.py:342-353
BON_ET_AL = {
    "simon_iter": dict(nb_fbs=1, p=9, cost_per_fbs=47),
    "ascon_lut": dict(nb_fbs=5, p=17, cost_per_fbs=75),
    "aes_sbox": dict(nb_fbs=36, p=11, cost_per_fbs=69),
}


def load(path: str) -> list[dict]:
    with open(path) as f:
        return [dict(r) for r in csv.DictReader(f)]


def load_measured(run_dir: Path) -> tuple[dict, dict]:
    """The runtime CLI's JSON lines in ``run_dir`` (``<bench>_<p>*.json``,
    the last line of each): every parseable run by file stem, and per bench
    the fastest bit-exact one as (seconds per evaluation, p, device)."""
    runs: dict[str, dict] = {}
    best: dict[str, tuple[float, int, str]] = {}
    for f in sorted(run_dir.glob("*.json")):
        try:
            r = json.loads(f.read_text().splitlines()[-1])
        except (ValueError, IndexError):
            continue
        if not isinstance(r, dict) or "run_s" not in r or "batch" not in r:
            continue
        runs[f.stem] = r
        if not r.get("bit_exact"):
            continue
        bench, _, p = f.stem.partition("_")
        p = p.split("_")[0]
        if not p.isdigit():
            continue
        s_per_eval = r["run_s"] / r["batch"]
        if bench not in best or s_per_eval < best[bench][0]:
            best[bench] = (s_per_eval, int(p), r.get("device", "?"))
    return runs, best


def measured_table(runs: dict, run_dir: Path) -> None:
    """One row per runtime-CLI JSON line, with the device it ran on: every
    comparison number comes from a file, none from prose."""
    if not runs:
        return
    print(f"\n## measured runs ({run_dir}/*.json)")
    hdr = ["run", "device", "staged", "batch", "levels", "boots", "ms/eval",
           "predicted ms/eval", "boots/s", "bit_exact"]
    print("| " + " | ".join(hdr) + " |")
    print("|" + "---|" * len(hdr))
    for name, r in sorted(runs.items()):
        pred = r.get("predicted_run_s")
        pred_ms = f"{pred / r['batch'] * 1e3:.1f}" if pred else "-"
        print(f"| {name} | {r.get('device', 'not recorded')} "
              f"| {r.get('staged')} | {r['batch']} "
              f"| {r.get('levels')} | {r.get('bootstraps')} "
              f"| {r['run_s'] / r['batch'] * 1e3:.1f} | {pred_ms} "
              f"| {r.get('boots_per_sec')} | {r.get('bit_exact')} |")


def _row_cost(r: dict) -> float:
    """Best estimate for a row: min(native, staged) total cost.

    ``staged_total`` is the dual-family pipeline estimate (sweep.py
    add_estimates via the keyless executor probe) — present only where the
    program compiles onto it."""
    costs = []
    for key in ("total_cost", "staged_total"):
        try:
            c = float(r.get(key, "nan") or "nan")
        except ValueError:
            continue
        if c == c:
            costs.append(c)
    return min(costs) if costs else float("nan")


def best_configs(rows: list[dict]) -> dict[str, dict]:
    """Per benchmark: the (mapper, p) config minimizing total cost
    (native or staged pipeline, whichever is cheaper for the row)."""
    best: dict[str, dict] = {}
    for r in rows:
        cost = _row_cost(r)
        b = r["bench"]
        if cost == cost and (b not in best
                             or cost < _row_cost(best[b])):
            best[b] = r
    return best


def mapper_vs_basic_table(rows: list[dict], latex: bool) -> None:
    """Reference f2/f2b (analyse_results.py:27-144): per bench and per
    mapper flavor (naive, search), the best-total_cost config with cost and
    #bootstraps expressed relative to the ``basic`` (bootstrap-every-gate)
    baseline, plus the chosen 'p (max_lut)'.  Basic counts as a candidate
    for each flavor (the reference concatenates basic rows into naive,
    :121-123), so a flavor never looks worse than the baseline."""
    base: dict[str, dict] = {}
    for r in rows:
        if r["mapper"] == "basic":
            base[r["bench"]] = r
    flavors = sorted({r["mapper"] for r in rows} - {"basic"})
    if not base or not flavors:
        return

    def best_for(bench: str, flavor: str) -> dict | None:
        cands = [r for r in rows if r["bench"] == bench
                 and r["mapper"] in (flavor, "basic")]
        cands = [r for r in cands
                 if r.get("total_cost") not in (None, "", "nan")]
        return min(cands, key=lambda r: float(r["total_cost"]),
                   default=None)

    hdr = ["bench"]
    for f in flavors:
        hdr += [f"{f}_cost_%", f"{f}_boots_%", f"{f}_p(lut)"]
    print("\n### best config vs basic baseline (cost/boots deltas, %)")
    sep = " & " if latex else " | "
    eol = r" \\" if latex else " |"
    lead = "" if latex else "| "
    print(lead + sep.join(hdr) + eol)
    if not latex:
        print("|" + "---|" * len(hdr))
    for bench in sorted(base):
        b = base[bench]
        cells = [bench]
        for f in flavors:
            r = best_for(bench, f)
            if r is None:
                cells += ["-", "-", "-"]
                continue
            dc = (float(r["total_cost"]) / float(b["total_cost"]) - 1) * 100
            db = (int(r["nb_bootstrap"]) / int(b["nb_bootstrap"]) - 1) * 100
            cells += [f"{dc:.0f}%", f"{db:.0f}%",
                      f"{r['fbs_size']} ({r['max_lut_size']})"]
        print(lead + sep.join(cells) + eol)


def beyond_parity_table(rows: list[dict]) -> None:
    """Head-to-head of the reference-parity ``search`` mapper vs the
    beyond-parity ``best`` racing mapper (ours; no reference counterpart):
    per (bench, p) bootstrap-count wins, and the per-bench minimum
    total_cost.  ``best`` is never worse by construction (it races search
    and keeps the cheaper program), so wins here are strict improvements
    over the reference heuristic on its own primary metric."""
    by_key: dict[tuple, dict[str, dict]] = defaultdict(dict)
    for r in rows:
        if r["mapper"] in ("search", "best"):
            by_key[(r["bench"], int(r["fbs_size"]))][r["mapper"]] = r
    pairs = {k: v for k, v in by_key.items() if len(v) == 2}
    if not pairs:
        return
    wins = []
    for (bench, p), v in sorted(pairs.items()):
        db = int(v["search"]["nb_bootstrap"]) - int(v["best"]["nb_bootstrap"])
        if db > 0:
            wins.append((bench, p, int(v["search"]["nb_bootstrap"]),
                         int(v["best"]["nb_bootstrap"])))
    print(f"\n### beyond parity: best-vs-search ({len(pairs)} paired "
          f"configs, {len(wins)} strict bootstrap-count wins, 0 losses "
          f"by construction)")
    for bench, p, s, b in wins:
        print(f"- {bench} p={p}: {s} -> {b} bootstraps "
              f"({(s - b) / s * 100:.0f}% fewer)")
    # per-bench best total_cost (any p), search vs best
    best_cost: dict[str, dict[str, float]] = defaultdict(dict)
    for r in rows:
        if r["mapper"] not in ("search", "best"):
            continue
        try:
            c = float(r["total_cost"])
        except (KeyError, ValueError):
            continue
        if c == c:
            cur = best_cost[r["bench"]].get(r["mapper"])
            if cur is None or c < cur:
                best_cost[r["bench"]][r["mapper"]] = c
    improved = [(b, v["search"], v["best"]) for b, v in sorted(
        best_cost.items()) if "search" in v and "best" in v
        and v["best"] < v["search"]]
    for b, s, c in improved:
        print(f"- {b}: min total_cost {s:.0f} -> {c:.0f} "
              f"({(s - c) / s * 100:.1f}% cheaper)")


def per_gate_time_stats(rows: list[dict]) -> None:
    """Reference f1 (analyse_results.py:16-25): map time divided by the
    source gate count.  Gate count proxy = the basic mapper's nb_bootstrap
    (basic bootstraps every gate), exactly as the reference does."""
    gates = {r["bench"]: int(r["nb_bootstrap"]) for r in rows
             if r["mapper"] == "basic"}
    per_mapper: dict[str, list[float]] = defaultdict(list)
    for r in rows:
        if r["mapper"] == "basic" or r["bench"] not in gates:
            continue
        try:
            per_mapper[r["mapper"]].append(
                float(r["time"]) / gates[r["bench"]] * 1000.0)
        except (KeyError, ValueError, ZeroDivisionError):
            pass
    if not per_mapper:
        return
    print("\n### map time per source gate (ms)")
    for m, ts in sorted(per_mapper.items()):
        ts.sort()
        mean = sum(ts) / len(ts)
        print(f"- {m}: mean {mean:.3f} median {ts[len(ts)//2]:.3f} "
              f"min {ts[0]:.3f} max {ts[-1]:.3f} over {len(ts)} runs")


def plot_suite(rows: list[dict], stem: str, out_dir: Path) -> None:
    """Cost-vs-p and #bootstraps-vs-p figures (PDF), one line per bench —
    parity with the reference's matplotlib figures
    (``analyse_results.py:148-166, 272-295, 299-388``).  Raises ImportError
    where matplotlib is not installed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for metric, fname in (("total_cost", f"{stem}_cost_vs_p.pdf"),
                          ("nb_bootstrap", f"{stem}_boots_vs_p.pdf")):
        by_bench: dict[str, list[tuple[int, float]]] = defaultdict(list)
        for r in rows:
            if r["mapper"] != "search":
                continue
            try:
                by_bench[r["bench"]].append(
                    (int(r["fbs_size"]), float(r[metric])))
            except (KeyError, ValueError):
                continue
        if not by_bench:
            continue
        fig, ax = plt.subplots(figsize=(7, 4.5))
        for bench, pts in sorted(by_bench.items()):
            pts.sort()
            ax.plot([p for p, _ in pts], [v for _, v in pts],
                    marker=".", label=bench, linewidth=1)
        ax.set_xlabel("FBS size p")
        ax.set_ylabel(metric)
        ax.set_yscale("log")
        if len(by_bench) <= 14:
            ax.legend(fontsize=6, ncol=2)
        fig.tight_layout()
        fig.savefig(out_dir / fname)
        plt.close(fig)
        print(f"# wrote {out_dir / fname}", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("csvs", nargs="+")
    ap.add_argument("--latex", action="store_true")
    ap.add_argument("--plots", action="store_true",
                    help="also write cost/boots-vs-p PDF figures")
    ap.add_argument("--measured", default=str(DEFAULT_ROOT / "runs"),
                    help="directory of the runtime CLI's JSON lines "
                         "(<bench>_<p>*.json) to merge as measured "
                         "per-eval seconds")
    args = ap.parse_args(argv)
    runs, measured = {}, {}
    if Path(args.measured).is_dir():
        runs, measured = load_measured(Path(args.measured))
        measured_table(runs, Path(args.measured))

    for path in args.csvs:
        rows = load(path)
        if not rows:
            print(f"# {path}: empty", file=sys.stderr)
            continue
        best = best_configs(rows)
        print(f"\n## {Path(path).stem}")
        hdr = ["bench", "mapper", "p", "nb_bootstrap", "norm2",
               "boot_cost_us", "total_cost_us", "rt_est_ms", "map_time_s"]
        if args.latex:
            print(" & ".join(hdr) + r" \\")
        else:
            print("| " + " | ".join(hdr) + " |")
            print("|" + "---|" * len(hdr))
        for b in sorted(best):
            r = best[b]
            # launch-aware runtime estimate (batch 16): min of the native
            # and staged predictions where present (sweep.py add_estimates)
            rts = []
            for key in ("native_rt_est", "staged_rt_est"):
                try:
                    v = float(r.get(key, "") or "nan")
                    if v == v:
                        rts.append(v)
                except ValueError:
                    pass
            rt = f"{min(rts) / 1e3:.1f}" if rts else "-"
            cells = [b, r["mapper"], r["fbs_size"], r["nb_bootstrap"],
                     r["norm2_linprod"], r["boot_cost"], r["total_cost"],
                     rt, f"{float(r['time']):.2f}"]
            if args.latex:
                print(" & ".join(map(str, cells)) + r" \\")
            else:
                print("| " + " | ".join(map(str, cells)) + " |")

        # AutoHoG comparison where applicable (reference
        # analyse_results.py:171-183 Fig.7 ISCAS85 + :215-244 Table IV
        # ISCAS89 — their numbers are CPU evaluation seconds; ours are the
        # H100 cost model's estimates for the best config)
        for label, table in (("ISCAS85", AUTOHOG_ISCAS85),
                             ("ISCAS89", AUTOHOG_ISCAS89)):
            # regenerated functional equivalents (bench_regen.py) carry an
            # 'r' suffix: join against the original's published numbers,
            # marked "(regen)" — a size-class comparison, not the exact
            # canonical netlist (no-egress regeneration; module docstring)
            def table_key(b):
                if b in table:
                    return b, ""
                if b.endswith("r") and b[:-1] in table:
                    return b[:-1], " (regen)"
                return None, ""
            auto = {b: r for b, r in best.items() if table_key(b)[0]}
            if not auto:
                continue
            print(f"\n### vs AutoHoG ({label}; seconds per evaluation, "
                  "speedup = TFHE-baseline / X; ours: H100 estimates)")
            for b in sorted(auto, key=lambda b: int(table_key(b)[0][1:])):
                r = auto[b]
                key, mark = table_key(b)
                base_s, autohog_s = table[key]
                ours_s = _row_cost(r) * 1e-6
                if ours_s != ours_s or ours_s <= 0:
                    continue
                meas = measured.get(b)
                meas_txt = (f" | measured {meas[0]:.4f}s on {meas[2]} "
                            f"({base_s / meas[0]:.0f}x)" if meas else "")
                print(f"- {b}{mark}: ours (est) {ours_s:.4f}s "
                      f"({base_s / ours_s:.2f}x){meas_txt} vs AutoHoG "
                      f"{autohog_s}s ({base_s / autohog_s:.2f}x); "
                      f"TFHE-baseline {base_s}s")

        # Bon et al. comparison where applicable
        printed_header = False
        for b, ref in BON_ET_AL.items():
            mine = [r for r in rows if r["bench"] == b
                    and int(r["fbs_size"]) == ref["p"]
                    and r["mapper"] == "search"]
            if not mine:
                continue
            if not printed_header:
                print("\n### vs Bon et al. (same p)")
                printed_header = True
            m = mine[0]
            print(f"- {b}: ours {m['nb_bootstrap']} FBS @ p={ref['p']} "
                  f"(norm2 {m['norm2_linprod']}) vs Bon et al. "
                  f"{ref['nb_fbs']} FBS, cost/FBS {ref['cost_per_fbs']}")

        # naive/search-vs-basic best-config tables (reference f2/f2b)
        mapper_vs_basic_table(rows, args.latex)

        # beyond-parity comparison (ours; only when 'best' rows exist)
        beyond_parity_table(rows)

        # map-time stats: raw and per source gate (reference f1)
        by_mapper = defaultdict(list)
        for r in rows:
            try:
                by_mapper[r["mapper"]].append(float(r["time"]))
            except (KeyError, ValueError):
                pass
        print("\n### map time (s): mean per mapper")
        for m, ts in sorted(by_mapper.items()):
            print(f"- {m}: mean {sum(ts)/len(ts):.3f} "
                  f"min {min(ts):.3f} max {max(ts):.3f} over {len(ts)} runs")
        per_gate_time_stats(rows)

        if args.plots:
            try:
                plot_suite(rows, Path(path).stem, Path(path).parent)
            except ImportError:
                print("# --plots: matplotlib is not installed, so no plots "
                      "were written", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
