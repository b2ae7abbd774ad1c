"""The port's sweep against the JAX package's ``experiments/sweep.py``.

The same inputs go through both modules: ``configs_for`` (sizes, mappers,
the basic baseline, the suite's ``--opt``), ``run_one`` (each mapping CLI
in its own process; the same ``.fbs`` and ``.lbf`` bytes; a second run
resumes) and ``aggregate`` (the stats columns, merged with an existing
aggregate), on c17 at p=3, 4 with ``--opt`` and on a generated program at
p=10, whose staged columns are priced.  Every column but the mapping's
wall ``time`` and the output paths' directory is equal.  Under the
JAX-constants profile the port's ``add_estimates`` gives the JAX sweep's
``boot_cost``, ``total_cost``, ``staged_total`` and ``staged_boot_cost``,
except on a ``basic`` row, which the port prices at the p its tables need
(3) where the JAX sweep prices the label's p=2; the ``*_rt_est`` columns
are each package's device model (the H100's against the TPU's) and are
held to the port's CLI in ``test_torch_sweep.py``."""

import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import tfhe_fbs_map_tpu.optimizer.optimizer as JO
import tfhe_fbs_map_tpu_torch.optimizer.optimizer as TO
from tfhe_fbs_map_tpu_torch.frontend.circuits import build_bench
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.harness import sweep

ROOT = Path(__file__).resolve().parents[1]

# the JAX module's TPU model as a profile (tests/test_torch_optimizer.py)
JAX_PROFILE = TO.DeviceProfile(
    name="jax", int8_ops=JO.MXU_INT8_OPS, mem_bytes=JO.HBM_BYTES,
    eff_fused=JO.MXU_EFF_FUSED, eff_otf=JO.MXU_EFF_OTF,
    k2_memory=JO.MATMUL_HBM_BUDGET, k2_headroom=0,
    generic_slowdown=JO.GENERIC_PATH_SLOWDOWN, cuda_kernels=False)
SEARCH_COLUMNS = ("boot_cost", "total_cost", "staged_total",
                  "staged_boot_cost")
RT_COLUMNS = ("native_rt_est", "staged_rt_est")


def jax_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_experiments_sweep", ROOT / "experiments" / "sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def named(cfg) -> tuple:
    """A config with its log as a file name."""
    return (*cfg[:4], cfg[4].name, *cfg[5:])


def same_columns(row: dict) -> dict:
    """A row without the mapping's wall time, its outputs by file name."""
    return {k: Path(v).name if k in ("output", "output_lbf") else v
            for k, v in row.items() if k != "time"}


@pytest.mark.parametrize("suite,name,sizes", [
    ("iscas85", "c17", [3, 4]),
    ("generated", "simon_iter", [10]),
])
def test_sweep_equals_jax(tmp_path, monkeypatch, suite, name, sizes):
    js = jax_sweep()
    monkeypatch.setitem(js.SWEEPS, suite, (sizes, True))
    if suite == "generated":
        bench = tmp_path / f"{name}.blif"
        with open(bench, "w") as f:
            build_bench(name).to_blif(fs=f, model_name=name)
    else:
        bench = ROOT / "benchmarks" / suite / f"{name}.bench"
    dirs = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
    for d in dirs.values():
        d.mkdir()
        # an earlier aggregate: a row whose log is gone survives, without
        # its cost columns; a row a fresh log replaces
        (d / "agg.csv").write_text(
            "bench,boot_cost,fbs_size,filename,mapper,nb_bootstrap,"
            "norm2_linprod,time,total_cost\n"
            "gone,1.0,4,b/gone.blif,search,7,3,0.2,7.0\n"
            f"{name},2.0,{sizes[0]},b/{name},search,99,9,9.9,198.0\n")

    cfgs = {"jax": list(js.configs_for(suite, [bench], dirs["jax"])),
            "torch": list(sweep.configs_for(suite, [bench], dirs["torch"],
                                            sizes=sizes))}
    assert [named(c) for c in cfgs["jax"]] == \
        [named(c) for c in cfgs["torch"]]
    assert [(c[2], c[3], c[6]) for c in cfgs["torch"]] == [
        (2, "basic", suite == "iscas85")] + [
        (p, "search", suite == "iscas85") for p in sizes]

    with ThreadPoolExecutor(8) as pool:
        done = {k: pool.map(mod.run_one, cfgs[k]) for k, mod in
                (("jax", js), ("torch", sweep))}
        done = {k: list(v) for k, v in done.items()}
    assert done["jax"] == done["torch"]
    assert all(m.startswith("done ") for m in done["torch"])
    for c in cfgs["torch"]:
        for ext in (".fbs", ".lbf"):
            theirs = (dirs["jax"] / c[4].name).with_suffix(ext)
            assert c[4].with_suffix(ext).read_bytes() == theirs.read_bytes()
    # a second run resumes from the logs
    again = {"jax": [js.run_one(c) for c in cfgs["jax"]],
             "torch": [sweep.run_one(c) for c in cfgs["torch"]]}
    assert again["jax"] == again["torch"]
    assert all(m.startswith("skip ") for m in again["torch"])

    rows = {"jax": js.aggregate(dirs["jax"], dirs["jax"] / "agg.csv"),
            "torch": sweep.aggregate(dirs["torch"],
                                     dirs["torch"] / "agg.csv")}
    assert [same_columns(r) for r in rows["jax"]] == \
        [same_columns(r) for r in rows["torch"]]
    assert len(rows["torch"]) == len(cfgs["torch"]) + 1
    fresh = next(r for r in rows["torch"] if r["bench"] == name
                 and r["fbs_size"] == sizes[0] and r["mapper"] == "search")
    assert fresh["nb_bootstrap"] != 99        # the fresh log wins

    js.add_estimates(rows["jax"], dirs["jax"] / "est.csv")
    sweep.add_estimates(rows["torch"], dirs["torch"] / "est.csv",
                        profile=JAX_PROFILE)
    for rj, rt in zip(rows["jax"], rows["torch"]):
        assert same_columns({k: v for k, v in rj.items()
                             if k not in SEARCH_COLUMNS + RT_COLUMNS}) == \
            same_columns({k: v for k, v in rt.items()
                          if k not in SEARCH_COLUMNS + RT_COLUMNS})
        for k in RT_COLUMNS:
            assert (rj[k] == "") == (rt[k] == "")
        if rt["mapper"] != "basic":
            assert [rj[k] for k in SEARCH_COLUMNS] == \
                [rt[k] for k in SEARCH_COLUMNS]
            continue
        # the JAX sweep prices the label's p=2, the port the p it runs at
        prog = parse_lbf(Path(rt["output_lbf"]).read_text())
        assert (rt["fbs_size"], prog.min_fbs_size()) == (2, 3)
        norm2 = float(rt["norm2_linprod"])
        assert rj["boot_cost"] == round(JO.optimize(2, norm2).cost, 1)
        assert rt["boot_cost"] == round(JO.optimize(3, norm2).cost, 1)
        assert rt["total_cost"] == round(
            rt["nb_bootstrap"] * JO.optimize(3, norm2).cost, 1)
    staged = [r for r in rows["torch"] if r["staged_total"] != ""]
    assert [(r["bench"], r["fbs_size"]) for r in staged] == (
        [(name, 10)] if suite == "generated" else [])
