"""BENCHMARK.json and the files it names: every configuration, traffic mix
and metric loads by its name, each per-layer metric's cells report the
end-to-end metric it moves, and a new cell or metric is added by adding
files and entries, with no edit to a file that is there."""

import json
import re
import shutil

import pytest

from bench_h100.harness.spec import (HERE, ROOT, cell_metrics,
                                     load_benchmark, load_cell,
                                     metric_reader)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return load_benchmark()


def test_contract_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["bench_h100"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[kind]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_every_file_loads_by_name(bench):
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"] == f"bench_h100/configs/{c['name']}.json"
    for w in bench["workloads"]:
        cell = load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert (HERE / cell.config["program"]).is_file()
        assert cell.traffic["batch"] % cell.traffic.get("dp", 1) == 0
        assert cell.chips == cell.traffic.get("dp", 1)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_each_cell_reports_what_its_metrics_move(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        names = {m["name"] for m in cell_metrics(bench, w["name"],
                                                 "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert cell_metrics(bench, w["name"], "per_layer")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            reported = {x["name"] for x in cell_metrics(bench, cell,
                                                        "end_to_end")}
            assert m["moves"] in reported, (m["name"], cell)


def test_a_new_cell_and_metric_need_no_edit(tmp_path, bench):
    here = tmp_path / "bench_h100"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    (here / "traffic" / "b2.json").write_text(json.dumps(
        {"batch": 2, "dp": 1}))
    (here / "metrics" / "batches.py").write_text(
        "def read(run):\n    return len(run.times)\n")
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "aes128_p4.b2", "config": "aes128_p4",
                             "traffic": "b2", "chips": 1, "why": "test"})
    new["per_layer"].append({"name": "batches.tput", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "executor", "moves": "evals_per_s",
                             "workloads": ["aes128_p4.b2"]})
    cell = load_cell("aes128_p4.b2", new, here=here)
    assert cell.traffic["batch"] == 2 and cell.config["p"] == 4
    assert metric_reader("batches.tput", here=here)(
        type("R", (), {"times": [1, 2]})) == 2
    for p, data in before.items():
        assert p.read_bytes() == data
