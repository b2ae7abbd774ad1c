"""The port's sweep harness (``tfhe_fbs_map_tpu_torch.harness``).

The JAX sweep's own tests on the port's module (aggregation merges with an
existing aggregate; the mapper override), the cost columns against the
port's own optimizer and runtime model through either search and against
the runtime CLI's pick, a run that writes only under its output
directory, the staged re-estimate, and the modules on a host with neither
pandas nor matplotlib.  ``test_torch_sweep_jax.py`` holds the sweep to
the JAX package's on the same inputs."""

import subprocess
import sys
from pathlib import Path

import pytest

from tfhe_fbs_map_tpu_torch.frontend import BasicMapper, HeuristicMapper
from tfhe_fbs_map_tpu_torch.frontend.circuits import build_bench
from tfhe_fbs_map_tpu_torch.harness import reestimate_staged, sweep
from tfhe_fbs_map_tpu_torch.optimizer import optimize
from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import (
    predict_native_us, predict_staged_us)
from tfhe_fbs_map_tpu_torch.runtime.cli import optimizer_pick, staged_solution
from tfhe_fbs_map_tpu_torch.runtime.executor import (native_level_boots,
                                                     staged_level_routes)

ROOT = Path(__file__).resolve().parents[1]


def test_aggregate_merges_with_existing_csv(tmp_path):
    (tmp_path / "foo_3_search.log").write_text(
        "junk\n{'filename': 'b/foo.blif', 'mapper': 'search', 'fbs_size': 3,"
        " 'nb_bootstrap': 5, 'norm2_linprod': 2, 'time': 0.1}\n")
    (tmp_path / "broken.log").write_text("not a dict\n")
    csv_path = tmp_path / "agg.csv"
    csv_path.write_text(
        "bench,boot_cost,fbs_size,filename,mapper,nb_bootstrap,"
        "norm2_linprod,time,total_cost\n"
        "bar,1.0,4,b/bar.blif,search,7,3,0.2,7.0\n"
        "foo,2.0,3,b/foo.blif,search,99,9,9.9,198.0\n")

    rows = sweep.aggregate(tmp_path, csv_path)
    assert len(rows) == 2
    fresh = next(r for r in rows if r["bench"] == "foo")
    assert fresh["nb_bootstrap"] == 5          # fresh log wins
    old = next(r for r in rows if r["bench"] == "bar")
    assert old["nb_bootstrap"] == 7            # CSV-only row survives
    # derived cost columns are recomputed downstream, never carried over
    assert "boot_cost" not in old and "total_cost" not in old
    assert sweep.read_rows(csv_path) == rows


def test_configs_for_mapper_override(tmp_path):
    benches = [tmp_path / "x.blif"]
    cfgs = list(sweep.configs_for("generated", benches, tmp_path,
                                  mappers=["best"]))
    assert all(c[3] == "best" for c in cfgs)           # no basic baseline
    assert {c[2] for c in cfgs} == set(range(2, 17))
    sized = list(sweep.configs_for("iscas85", benches, tmp_path,
                                   sizes=sweep.parse_sizes("3,4")))
    assert [(c[2], c[3], c[6]) for c in sized] == [
        (2, "basic", True), (3, "search", True), (4, "search", True)]
    assert sweep.parse_sizes("2-5") == [2, 3, 4, 5]


def mapped_row(tmp_path, name: str, p: int, mapper: str = "search"
               ) -> tuple:
    """A generated benchmark mapped at ``p`` (``basic``: labelled p=2) into
    ``tmp_path``: a sweep row (the stats the mapping CLI prints, and its
    .lbf) and the program."""
    if mapper == "basic":
        prog = BasicMapper().map(build_bench(name))
    else:
        prog = HeuristicMapper(cone_merger=mapper, fbs_size=p).map(
            build_bench(name))
    prog.remove_dangling_nodes()
    lbf = tmp_path / f"{name}_{p}_{mapper}.lbf"
    with open(lbf, "w") as f:
        prog.write_lbf(os=f)
    return dict(prog.stats(), bench=name, mapper=mapper, fbs_size=p,
                output_lbf=str(lbf)), prog


@pytest.mark.parametrize("native", [True, False])
def test_add_estimates_prices_rows_on_the_h100(tmp_path, native):
    """Each cost column is what the port's optimizer and runtime model give
    (the calibrated H100 profile, batch 16), through the C++ search and the
    Python one: a native row, and a p=10 row with the staged columns where
    the staged search finds families."""
    native_row, nprog = mapped_row(tmp_path, "full_adder", 3)
    staged, sprog = mapped_row(tmp_path, "simon_iter", 10)
    rows = [native_row, staged]
    sweep.add_estimates(rows, tmp_path / "est.csv", native=native)
    for r, prog in ((native_row, nprog), (staged, sprog)):
        sol = optimize(r["fbs_size"], float(r["norm2_linprod"]))
        assert r["boot_cost"] == round(sol.cost, 1)
        assert r["total_cost"] == round(r["nb_bootstrap"] * sol.cost, 1)
        assert r["native_rt_est"] == round(predict_native_us(
            sol, native_level_boots(prog), sweep.RT_BATCH), 1)
    assert native_row["staged_total"] == native_row["staged_rt_est"] == ""
    ssol = staged_solution(sprog, 10)
    assert ssol is not None
    assert staged["staged_total"] == round(ssol.cost, 1)
    assert staged["staged_rt_est"] == round(predict_staged_us(
        ssol, staged_level_routes(sprog, 10), sweep.RT_BATCH), 1)
    assert staged["staged_boot_cost"] == round(
        ssol.cost / staged["nb_bootstrap"], 1)
    assert sweep.read_rows(tmp_path / "est.csv")[1]["staged_total"] \
        == staged["staged_total"]


def test_rows_are_priced_as_the_cli_runs_them(tmp_path):
    """At the runtime CLI's error target the ``*_rt_est`` columns are the
    µs an evaluation its pick predicts at batch 16, native and staged; a
    ``basic`` row (labelled p=2, its AND tables need p=3) is priced at the
    p=3 the CLI runs it at with ``--fbs_size 3``."""
    rows = [mapped_row(tmp_path, "full_adder", 2, "basic"),
            mapped_row(tmp_path, "full_adder", 3),
            mapped_row(tmp_path, "simon_iter", 10)]
    sweep.add_estimates([r for r, _ in rows], tmp_path / "est.csv",
                        p_error=1e-7)
    for r, prog in rows:
        p_run = max(r["fbs_size"], prog.min_fbs_size())
        native = optimizer_pick(prog, p_run, sweep.RT_BATCH, "off", 1e-7)
        assert r["native_rt_est"] == round(native.native_us, 1)
        sol = optimize(p_run, float(r["norm2_linprod"]), max_p_error=1e-7)
        assert r["boot_cost"] == round(sol.cost, 1)
    basic = rows[0][0]
    assert (basic["fbs_size"], rows[0][1].min_fbs_size()) == (2, 3)
    assert basic["boot_cost"] != round(optimize(
        2, float(basic["norm2_linprod"]), max_p_error=1e-7).cost, 1)
    staged, sprog = rows[2]
    pick = optimizer_pick(sprog, 10, sweep.RT_BATCH, "on", 1e-7)
    assert staged["staged_rt_est"] == round(pick.staged_us, 1)


@pytest.mark.parametrize("native", [True, False])
def test_sweep_prices_with_the_search_the_host_builds(tmp_path, monkeypatch,
                                                      capsys, native):
    """The C++ search where its library builds, else the Python one: the
    same aggregate either way."""
    import tfhe_fbs_map_tpu_torch.optimizer.native as native_mod
    monkeypatch.setattr(native_mod, "native_available", lambda: native)
    used = []
    real = sweep.searches
    monkeypatch.setattr(sweep, "searches", lambda n, profile=None: (
        used.append(n), real(n, profile))[1])
    assert sweep.main(["--suite", "iscas85", "--bench", "c17", "--sizes",
                       "3", "--root", str(tmp_path)]) == 0
    assert used == [native]
    out = capsys.readouterr().out
    assert ("(native search)" if native else "(python search: no g++)") \
        in out
    out_dir = tmp_path / "iscas85"
    rows = sweep.read_rows(out_dir / "iscas85_agg.csv")
    sweep.add_estimates(rows, out_dir / "other.csv", native=not native)
    assert sweep.read_rows(out_dir / "other.csv") == \
        sweep.read_rows(out_dir / "iscas85_agg_est.csv")


def snapshot() -> dict:
    """Every file under the repo's ``benchmarks/`` and ``outputs/`` with its
    size and modification time."""
    out = {}
    for top in ("benchmarks", "outputs"):
        for p in (ROOT / top).rglob("*"):
            if p.is_file():
                st = p.stat()
                out[p] = (st.st_size, st.st_mtime_ns)
    return out


def test_run_writes_only_under_its_output_directory(tmp_path, capsys):
    before = snapshot()
    assert sweep.main(["--suite", "iscas85", "--bench", "c17", "--sizes",
                       "3", "--root", str(tmp_path)]) == 0
    assert snapshot() == before
    written = sorted(p.relative_to(tmp_path)
                     for p in tmp_path.rglob("*") if p.is_file())
    assert [str(p) for p in written] == [
        f"iscas85/{n}" for n in (
            "c17_2_basic.fbs", "c17_2_basic.lbf", "c17_2_basic.log",
            "c17_3_search.fbs", "c17_3_search.lbf", "c17_3_search.log",
            "iscas85_agg.csv", "iscas85_agg_est.csv")]
    rows = sweep.read_rows(tmp_path / "iscas85" / "iscas85_agg_est.csv")
    assert [(r["bench"], r["fbs_size"], r["mapper"]) for r in rows] == [
        ("c17", 2, "basic"), ("c17", 3, "search")]
    for r in rows:
        assert all(r[k] == r[k] and r[k] > 0 for k in (
            "boot_cost", "total_cost", "native_rt_est"))
    # a second run resumes: every config's log is there
    assert sweep.main(["--suite", "iscas85", "--bench", "c17", "--sizes",
                       "3", "--root", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("skip ") == 2


def test_reestimate_recomputes_the_staged_columns(tmp_path):
    """A staged row's columns are computed again from its program; a row
    whose circuit file is missing keeps its estimate."""
    out = tmp_path / "generated"
    (out / "bench").mkdir(parents=True)
    with open(out / "bench" / "simon_iter.blif", "w") as f:
        build_bench("simon_iter").to_blif(fs=f, model_name="simon_iter")
    row, _ = mapped_row(out, "simon_iter", 10)
    sweep.add_estimates([row], out / "generated_agg_est.csv")
    rows = sweep.read_rows(out / "generated_agg_est.csv")
    want = rows[0]["staged_total"], rows[0]["staged_rt_est"]
    rows[0]["staged_total"] = rows[0]["staged_rt_est"] = 1.0
    rows.append(dict(rows[0], bench="gone", staged_total=7.0))
    sweep.write_rows(rows, out / "generated_agg_est.csv")
    reestimate_staged.main(["--suite", "generated", "--root",
                            str(tmp_path)])
    got = sweep.read_rows(out / "generated_agg_est.csv")
    assert (got[0]["staged_total"], got[0]["staged_rt_est"]) == want
    assert got[1]["staged_total"] == 7.0


def test_imports_without_pandas_and_matplotlib(tmp_path):
    csv_path = tmp_path / "agg_est.csv"
    csv_path.write_text(
        "bench,boot_cost,fbs_size,mapper,nb_bootstrap,norm2_linprod,time,"
        "total_cost,max_lut_size\n"
        "c17,18.4,3,search,4,6,0.01,73.8,5\n")
    code = ("import sys\n"
            "sys.modules['pandas'] = None\n"
            "sys.modules['matplotlib'] = None\n"
            "import tfhe_fbs_map_tpu_torch.harness.sweep\n"
            "import tfhe_fbs_map_tpu_torch.harness.reestimate_staged\n"
            "from tfhe_fbs_map_tpu_torch.harness import analyse\n"
            f"sys.exit(analyse.main([{str(csv_path)!r}, '--plots', "
            f"'--measured', {str(tmp_path / 'none')!r}]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert "| c17 | search | 3 | 4 | 6 | 18.4 | 73.8 |" in res.stdout
    assert "matplotlib is not installed" in res.stderr


def test_measured_table_prints_the_device(tmp_path, capsys):
    from tfhe_fbs_map_tpu_torch.harness import analyse
    runs = tmp_path / "runs"
    runs.mkdir()
    (runs / "c17_3.json").write_text(
        '# log\n{"staged": false, "bit_exact": true, "batch": 16, '
        '"levels": 2, "bootstraps": 4, "run_s": 0.032, '
        '"predicted_run_s": 0.034, "boots_per_sec": 2000.0, '
        '"device": "NVIDIA H100 80GB HBM3"}\n')
    (runs / "bad.json").write_text("not json\n")
    got, best = analyse.load_measured(runs)
    assert list(got) == ["c17_3"]
    assert best == {"c17": (0.002, 3, "NVIDIA H100 80GB HBM3")}
    analyse.measured_table(got, runs)
    out = capsys.readouterr().out
    assert "| c17_3 | NVIDIA H100 80GB HBM3 | False | 16 | 2 | 4 | 2.0 " \
        "| 2.1 |" in out


@pytest.mark.parametrize("suite", ["generated", "epfl"])
def test_regenerated_suites_write_into_the_output_directory(tmp_path,
                                                             suite):
    src = sweep.bench_dir(suite, tmp_path / suite)
    assert src == tmp_path / suite / "bench"
    (sweep.ensure_generated if suite == "generated"
     else sweep.ensure_epfl)(src)
    names = sorted(p.stem for p in src.glob("*.blif"))
    committed = sorted(p.stem for p in (ROOT / "benchmarks" / suite)
                       .glob("*.blif"))
    assert names == committed
    assert sweep.bench_dir("iscas89", tmp_path) == \
        ROOT / "benchmarks" / "iscas89"
