"""The port's level profiler on the CPU: every level timed, the run still
bit-exact, the traced window reporting no device numbers without a device."""

import json

import numpy as np
import pytest
import torch

from tfhe_fbs_map_tpu.frontend import HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu_torch.runtime.profile import main, profile_program
from tfhe_fbs_map_tpu_torch.tfhe import TEST_PARAMS

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)


def full_adder():
    prog = HeuristicMapper(cone_merger="search", fbs_size=4) \
        .map(build_bench("full_adder"))
    prog.remove_dangling_nodes()
    return prog


@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_every_level_timed_and_bit_exact(orientation):
    prog = full_adder()
    res = profile_program(prog, TEST_PARAMS, 3, orientation,
                          torch.device("cpu"), trace=1)
    ev = res["events"]
    assert ev["levels"] == res["program_levels"] >= 1
    assert ev["bit_exact"]
    groups = ev["by_ciphertexts_per_launch"]
    assert sum(g["levels"] for g in groups.values()) == ev["levels"]
    assert all(int(w) % 3 == 0 for w in groups)
    assert 0 < ev["sum_kernel_ms"] <= ev["sum_level_ms"] <= ev["wall_s"] * 1e3
    assert list(ev["by_family"]) == ["native"]
    assert ev["by_family"]["native"]["launches"] == ev["levels"]
    prof = res["profile"]
    assert prof["window_levels"] == 1 and prof["device_events"] == 0
    assert prof["idle_share"] is None and "tile_sweep" not in res


def test_staged_preset_times_each_family():
    """A staged preset runs both families' calls through the executor's
    step, and their kernel times are reported per family."""
    from test_staged_executor import build_mixed_program
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    prog = build_mixed_program(np.random.default_rng(2))
    res = profile_program(prog, STAGED_PRESETS["staged_test"], 2,
                          "fused_otf", torch.device("cpu"), trace=2)
    ev = res["events"]
    assert res["staged"] and ev["bit_exact"] and ev["levels"] == 4
    fams = ev["by_family"]
    # (fam1, fam2) calls a level: (1, 1), (0, 1), (1, 0), (1, 1)
    assert {f: v["launches"] for f, v in fams.items()} == {"fam1": 3,
                                                          "fam2": 3}
    assert ev["sum_kernel_ms"] == pytest.approx(
        sum(v["kernel_ms"] for v in fams.values()))
    assert sum(g["levels"] for g in
               ev["by_ciphertexts_per_launch"].values()) == 4
    assert res["profile"]["window_levels"] == 2


def test_cli_prints_json_and_writes_it(tmp_path, capsys):
    lbf, out = tmp_path / "fa.lbf", tmp_path / "prof.json"
    with open(lbf, "w") as f:
        full_adder().write_lbf(f)
    rc = main([str(lbf), "--params", "test", "--batch", "2", "--device",
               "cpu", "--levels", "1", "--trace-levels", "0", "--out",
               str(out)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res == json.loads(out.read_text())
    ev = res["events"]
    assert ev["levels"] == 1 and "profile" not in res
    # outputs are checked only when every level ran
    assert ev.get("bit_exact") is (True if res["program_levels"] == 1
                                   else None)


def test_cuda_without_a_device_fails_clearly(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([str(tmp_path / "absent.lbf")]) != 0
    assert "no CUDA device" in capsys.readouterr().err
