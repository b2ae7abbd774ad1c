"""The frozen operation and byte counts against the bounds the repository
recorded before the benchmark (PERF.md: 11.29 ms for a blind rotation of
1,024 ciphertexts at aes128_p4, 44.59 ms at Kreyvium's fam1), and the
padding share of both compiled plans."""

import json
from types import SimpleNamespace

import pytest

from bench_h100.harness import roofline
from bench_h100.harness.cell import plan_calls
from bench_h100.harness.spec import HERE


def family(name, i=0):
    with open(HERE / "configs" / f"{name}.json") as f:
        return json.load(f)["families"][i]


@pytest.mark.parametrize("name, want_ms", [("aes128_p4", 11.29),
                                            ("kreyvium_p10_staged", 44.59)])
def test_rotation_bound_at_1024(name, want_ms):
    ops, nbytes = roofline.rotation(family(name), 1024)
    assert ops / roofline.PEAK_INT8_OPS > nbytes / roofline.PEAK_BYTES
    rot, boot = roofline.call_least_s(family(name), 1024)
    assert round(rot * 1e3, 2) == want_ms
    # the key switch adds its own operations, a fraction of a percent
    assert rot < boot < rot * 1.01


def test_padding_counts_nothing():
    assert roofline.call_least_s(family("aes128_p4"), 0) == (0.0, 0.0)
    one = roofline.call_least_s(family("aes128_p4"), 1)
    two = roofline.call_least_s(family("aes128_p4"), 2)
    assert two[0] == pytest.approx(2 * one[0])


def test_limbs_are_the_algorithms():
    # four 8-bit limbs of a 32-bit key, whatever key a run builds
    assert roofline.LIMBS == 4
    fam = family("aes128_p4")
    ops, _ = roofline.rotation(fam, 1)
    n, k1, N, l = 578, 3, 512, 2
    assert ops == 2 * n * k1 * l * N * 4 * k1 * N


def _plan(name):
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.runtime.executor import (compile_program,
                                                         compile_staged)
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams

    with open(HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    prog = parse_lbf((HERE / cfg["program"]).read_text())
    fams = [TFHEParams(**f) for f in cfg["families"]]
    plan = (compile_staged(prog, cfg["p"], *fams) if cfg["staged"]
            else compile_program(prog, fams[0]))
    ex = SimpleNamespace(levels=plan.levels, staged=cfg["staged"],
                         dummy_row=plan.dummy_row)
    return plan_calls(ex, cfg["families"]), plan


@pytest.mark.parametrize("name, share, levels", [
    ("aes128_p4", 29.3, 230), ("kreyvium_p10_staged", 27.6, 25)])
def test_pad_share_of_the_plans(name, share, levels):
    from bench_h100.harness.cell import Run

    calls, plan = _plan(name)
    assert len(plan.levels) == levels
    slots = sum(s for *_, s in calls)
    real = sum(r for _, r, _ in calls)
    assert real == plan.num_bootstraps
    run = Run(None, 8, 1, 0.0, [1.0], slots, real, 0.0, 0.0)
    from bench_h100.harness.spec import metric_reader
    assert round(metric_reader("pad_share.tput")(run), 1) == share
