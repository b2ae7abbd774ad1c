"""The port's scaling study (``harness/scaling_study.py``) on the CPU: dp 1
and 2 with 2 iterations and one 2-process point, as a user runs it; its
JSON has the JAX study's keys, the efficiency covers the pinned points only,
the two gloo ranks are ok, and a point that reports errors or a rank that
fails makes the study exit 1.  The card's side (shared-card points) is
held on a faked one-card host; ``chip_smoke.py`` phase 12 (c) runs it on
the card."""

import json
import subprocess

import pytest
import torch

from tfhe_fbs_map_tpu_torch.harness import scaling_study as S

# experiments/scaling_study.py:128-146, the JAX study's result keys
JAX_KEYS = {"metric", "host_cores", "batch_per_chip", "orientation",
            "points", "efficiency_core_proportional", "efficiency",
            "efficiency_devices", "oversubscribed_total_boots_per_sec",
            "tp_points", "tp2_efficiency", "multiprocess_points", "note"}


@pytest.fixture(scope="module")
def cpu_study(tmp_path_factory, monkeypatch_module):
    """``main --device cpu --iters 2`` at dp 1 and 2 and one 2-process
    point, as written to its JSON."""
    monkeypatch_module.setattr(S, "DEFAULT_DP", (1, 2))
    monkeypatch_module.setattr(S, "DEFAULT_PROCS", (2,))
    out = tmp_path_factory.mktemp("study") / "scaling.json"
    rc = S.main(["--device", "cpu", "--iters", "2", "--out", str(out)])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_cpu_study_has_the_jax_keys(cpu_study):
    rc, res = cpu_study
    assert rc == 0
    assert set(res) == JAX_KEYS | {"device"}
    assert res["device"] == "cpu" and res["orientation"] == "fused_otf"
    assert [p["dp"] for p in res["points"]] == [1, 2]
    assert all(p["errors"] == 0 and p["value"] > 0 for p in res["points"])
    # --quick caps the batch a position at 16, as in the JAX study
    assert all(p["batch_per_chip"] == 16 for p in res["points"])
    # JAX's two tp points: matmul at dp=1 on one pinned core, tp=2 on two
    m1, m2 = res["tp_points"]
    assert (m1["dp"], m1["tp"], m2["dp"], m2["tp"]) == (1, 1, 1, 2)
    assert m1["errors"] == m2["errors"] == 0
    assert m1["orientation"] == m2["orientation"] == "matmul"
    assert (m1["pinned_cores"], m2["pinned_cores"]) == (1, 2)
    assert res["tp2_efficiency"] == round(m2["value"] / (2 * m1["value"]),
                                          3)
    assert "tp=2 = the matmul orientation" in res["note"]


def test_cpu_study_efficiency_over_pinned_points(cpu_study):
    _, res = cpu_study
    pinned = {str(p["dp"]) for p in res["points"] if p["pinned_cores"]}
    assert set(res["efficiency_core_proportional"]) == pinned
    assert set(res["oversubscribed_total_boots_per_sec"]) == {
        str(p["dp"]) for p in res["points"] if not p["pinned_cores"]}
    base = res["points"][0]["value"]
    for p in res["points"]:
        if p["pinned_cores"]:
            assert res["efficiency_core_proportional"][str(p["dp"])] == \
                round(p["value"] / (p["dp"] * base), 3)


def test_cpu_study_two_gloo_ranks_are_ok(cpu_study):
    _, res = cpu_study
    (mp,) = res["multiprocess_points"]
    assert (mp["procs"], mp["ok"], mp["errors"]) == (2, 2, 0)
    assert mp["wall_s"] > 0


def fake_point(values):
    def run_point(n, batch, iters, orientation, device, quick, cards=0,
                  tp=1):
        r = {"metric": "bootstraps_per_sec_total", "value": values[n],
             "devices": min(n, cards) if device == "cuda" else 1,
             "dp": n // tp, "tp": tp,
             "boots_per_sec_per_chip": values[n] / n,
             "batch_per_chip": batch, "orientation": orientation,
             "errors": 0}
        if device == "cpu":
            r["pinned_cores"] = n if n <= 2 else None
        else:
            r["shared_card"] = n > cards
        return r
    return run_point


def ok_ranks(procs, device):
    return {"metric": "torch_distributed_multiprocess", "procs": procs,
            "device": device, "ok": procs, "errors": 0, "wall_s": 1.0}


def test_efficiency_leaves_out_oversubscribed_points(monkeypatch):
    monkeypatch.setattr(S, "run_point", fake_point({1: 100.0, 2: 180.0,
                                                    4: 200.0, 8: 210.0}))
    monkeypatch.setattr(S, "run_multiprocess", ok_ranks)
    res = S.study("cpu", 48, 4, "fused_otf", True)
    assert res["efficiency_core_proportional"] == {1: 1.0, 2: 0.9}
    assert (res["efficiency"], res["efficiency_devices"]) == (0.9, 2)
    assert res["oversubscribed_total_boots_per_sec"] == {4: 200.0, 8: 210.0}
    # both tp points pinned: value(tp=2) / (2 value(tp=1))
    assert res["tp2_efficiency"] == 0.9


def test_one_card_claims_no_scaling(monkeypatch):
    """On one card dp 2-8 share it: only dp 1 is real, no efficiency is
    claimed, the JSON names the card and says so."""
    monkeypatch.setattr(S, "run_point", fake_point({1: 100.0, 2: 190.0,
                                                    4: 200.0, 8: 205.0}))
    monkeypatch.setattr(S, "run_multiprocess", ok_ranks)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(S, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    res = S.study("cuda", 48, 4, "fused_otf", True)
    assert [p["shared_card"] for p in res["points"]] == [False, True, True,
                                                         True]
    assert res["efficiency_core_proportional"] == {1: 1.0}
    assert res["efficiency"] is None and res["efficiency_devices"] is None
    assert set(res["oversubscribed_total_boots_per_sec"]) == {2, 4, 8}
    assert res["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert res["cards"] == 1 and "only dp=1 is real" in res["note"]
    # the tp=2 point shares the card: kept, no efficiency
    assert [p["shared_card"] for p in res["tp_points"]] == [False, True]
    assert res["tp2_efficiency"] is None


def test_a_point_with_errors_exits_1(monkeypatch, tmp_path, capsys):
    """bench_multichip reporting decode errors (and exiting 1 on them)
    fails the study: exit 1, nothing written."""
    line = json.dumps({"value": 1.0, "dp": 1, "errors": 3})

    def run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, line + "\n", "")
    monkeypatch.setattr(S.subprocess, "run", run)
    out = tmp_path / "s.json"
    assert S.main(["--device", "cpu", "--out", str(out)]) == 1
    assert not out.exists()
    assert "3 decode errors" in capsys.readouterr().err


def test_a_failed_rank_exits_1(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(S, "run_point", fake_point({1: 100.0, 2: 180.0}))
    monkeypatch.setattr(S, "_run_workers", lambda procs, device, port: [
        (0, "DISTRIBUTED_OK rank=0 procs=2 positions=4 launches=0\n"),
        (1, "DISTRIBUTED_WRONG rank=1\n")])
    out = tmp_path / "s.json"
    monkeypatch.setattr(S, "DEFAULT_DP", (1, 2))
    monkeypatch.setattr(S, "DEFAULT_PROCS", (2,))
    assert S.main(["--device", "cpu", "--out", str(out)]) == 1
    assert not out.exists()
    assert "1 ranks failed" in capsys.readouterr().err


def test_refusals(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert S.main(["--device", "cuda"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
