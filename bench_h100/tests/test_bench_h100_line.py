"""The run's last line has the contract's keys and no others, and a run on
a machine without enough CUDA devices fails with no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_h100.harness.cell import run_cell
from bench_h100.harness.spec import ROOT, load_benchmark

sys.path.insert(0, str(ROOT / "bench_h100"))
import run as bench_run  # noqa: E402


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(tiny, monkeypatch, trace):
    cell = tiny("native")
    run = run_cell(cell, 3, 0.0, trace, ["cpu"], batches=1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    bench = load_benchmark()
    bench["workloads"].append({"name": cell.name, "config": "x",
                               "traffic": "y", "chips": 1, "why": "t"})
    line = bench_run.result_line(run, bench, trace)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if trace else []) \
        + ["compared"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True and line["attempted"] == 8
    json.dumps(line)
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench_h100" / "run.py"), "--workload",
         "aes128_p4.b8", "--seed", str(2 ** 31 + 5), "--seconds", "10",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_alone_the_benchmark_folder_fails(tmp_path):
    import shutil

    shutil.copytree(ROOT / "bench_h100", tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", "aes128_p4.b8",
         "--seed", "1", "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
