"""The port's launch-aware runtime model and its H100 calibration.

The keyless level counts equal the JAX package's; the model's launch plans
and waves equal ``k1_plan`` / ``k2_plan``'s under the recorded resident
table, and the plans the card launched while it was calibrated; the JAX
runtime-model tests, mirrored; every optimizer pick gets a prediction; and
the calibration's fit, on points made from known constants."""

import math
import statistics
from pathlib import Path

import pytest
import torch

from tfhe_fbs_map_tpu.frontend.lut_program import parse_lbf as jparse
from tfhe_fbs_map_tpu.optimizer.runtime_model import bucket as jbucket
from tfhe_fbs_map_tpu.runtime.executor import \
    native_level_boots as jnative_level_boots
from tfhe_fbs_map_tpu_torch.frontend.lut_program import LutProgram, parse_lbf
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.optimizer import calibrate, validate
from tfhe_fbs_map_tpu_torch.optimizer import runtime_model as rm
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import KSK_MAX_BASE_LOG
from tfhe_fbs_map_tpu_torch.ops.fused_blind_rotate import unsupported
from tfhe_fbs_map_tpu_torch.optimizer.noise import P_ERROR_4_SIGMA
from tfhe_fbs_map_tpu_torch.optimizer.optimizer import (Solution,
                                                        StagedSolution,
                                                        bootstrap_cost_us,
                                                        calibration,
                                                        h100_profile, optimize,
                                                        optimize_staged)
from tfhe_fbs_map_tpu_torch.runtime.cli import (pick_orientations,
                                                predicted_run_s)
from tfhe_fbs_map_tpu_torch.runtime.executor import (CircuitExecutor,
                                                     native_level_boots,
                                                     staged_level_routes)
from tfhe_fbs_map_tpu_torch.tfhe import TEST_PARAMS, generate_keys
from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams

torch.set_num_threads(1)
CPU = torch.device("cpu")

OUTPUTS = Path(__file__).resolve().parents[1] / "outputs"
PROGRAMS = [OUTPUTS / "bristol" / "aes_128_4_search.lbf",
            OUTPUTS / "generated" / "kreyvium_stream_v1_10_search.lbf"]


def shell(key: str, p: int = 2) -> TFHEParams:
    """Params of a calibration key ``n,k,N,l,ks_l`` (the plans read only
    the sizes)."""
    n, k, N, l, ks_l = (int(x) for x in key.split(","))
    return TFHEParams(p=p, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=5, ksk_level=ks_l, ksk_base_log=2,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def chain_program(levels=3, width=4):
    """``levels`` levels of ``width`` distinct bootstraps each."""
    prog = LutProgram()
    wires = [prog.input(f"x{i}") for i in range(width)]
    for lv in range(levels):
        nxt = []
        for i in range(width):
            lin = prog.linear([1, 2], [wires[i], wires[(i + 1) % width]],
                              const_coef=lv % 2)
            table = [(v + i) % 2 for v in range(3 + lv % 2 + 1)]
            nxt.append(prog.bootstrap(lin, table))
        wires = nxt
    for i, w in enumerate(wires):
        prog.output(f"o{i}", w)
    return prog


# ------------------------------------------------------- keyless counts

@pytest.mark.parametrize("path", PROGRAMS, ids=lambda p: p.stem)
def test_native_level_boots_equals_jax(path):
    text = path.read_text()
    got = native_level_boots(parse_lbf(text))
    assert got == jnative_level_boots(jparse(text))
    assert len(got) == {"aes_128_4_search": 230,
                        "kreyvium_stream_v1_10_search": 25}[path.stem]


def test_native_level_boots_matches_executor_plan():
    prog = chain_program(levels=3, width=3)
    nlb = native_level_boots(prog)
    ex = CircuitExecutor(prog, generate_keys(TEST_PARAMS.with_p(8), seed=0,
                                       device=CPU))
    assert len(nlb) == len(ex.levels) and sum(nlb) == ex.num_bootstraps
    for nb, plan in zip(nlb, ex.levels):
        assert plan.wire_idx.shape[0] == rm.bucket(nb)


def test_bucket_equals_jax():
    xs = (1, 2, 3, 4, 5, 511, 512, 513, 8754)
    assert [rm.bucket(x) for x in xs] == [jbucket(x) for x in xs]


# ------------------------------------------------------ plans and waves

def recorded_points():
    return calibration()["raw"]["points"]


def test_calibration_names_the_card_and_keys_families_fully():
    cal = calibration()
    assert "H100" in cal["card"] and cal["card"].endswith(" W")
    assert cal["sms"] == cal["raw"]["sms"] > 0
    for key, entry in cal["families"].items():
        family, _, kernel = key.partition("/")
        assert len(family.split(",")) == 5         # n, k, N, l, ks_l
        assert kernel == entry["kernel"] in ("fused", "fused_otf", "k1s")
        if kernel == "k1s":
            # K1's small-tile plan at N >= 256: its own points, priced by
            # the launch size
            assert int(family.split(",")[2]) >= fbr.K1_SLICE
            assert [r for r, _ in entry["points"]] == list(rm.SMALL_ROWS)
    names = {e["name"] for e in cal["families"].values()}
    assert set(calibrate.families()) <= names
    # the staged families were timed through K1, as the CLI runs them;
    # every family through the kernel the model prices for it
    for name, (params, staged) in calibrate.families().items():
        assert rm._entry(params, "fused_otf")["name"] == name
        if staged:
            assert rm._entry(params, "fused") is None
        else:
            kern = h100_profile().kernel(
                params.lwe_dim, params.glwe_dim, params.poly_size,
                params.bsk_level, params.ksk_level)
            assert rm._entry(params, kern)["name"] == name


@pytest.mark.parametrize("i", range(len(recorded_points())))
def test_model_plan_is_the_cards(i):
    """The plan and waves the card launched with at every calibration
    point (``k1_device_plan`` / ``device_plan`` and the card's
    ``cudaOccupancyMaxActiveClusters``) are the model's, from the SM count
    and the resident table alone."""
    pt = recorded_points()[i]
    # K1's points at N >= 256 were timed on its ring kernel
    # (calibrate.time_family), whatever the route would take there now
    plan, waves = rm.launch_plan(shell(pt["key"]), pt["rows"], pt["kernel"],
                                 pt["limbs"],
                                 "k1" if pt["kernel"] == "fused_otf" else None)
    assert list(plan) == pt["plan"] and waves == pt["waves"]


@pytest.mark.parametrize("kernel", ["fused", "fused_otf"])
@pytest.mark.parametrize("key", ["578,2,512,2,6", "642,1,1024,4,6",
                                 "642,2,512,4,3", "706,1,2048,3,7"])
@pytest.mark.parametrize("limbs", [3, 4])
def test_model_plan_is_the_planners_under_the_table(kernel, key, limbs):
    cal = calibration()
    sms, table = cal["sms"], cal["resident"]
    params = shell(key)

    def resident(plan):
        key = rm.resident_key(kernel, limbs, plan, params)
        assert key in table
        return table[key]
    for rows in (8, 64, 1024, 2048, 4096, 8192, 20000):
        if kernel == "fused_otf":
            # K1 on the route, tile and cluster the cost model chooses
            c = rm.launch_choice(params, rows, 1, kernel, limbs)
            want = fbr.k1_plan(rows, params, sms, limbs,
                               *(c.tile or (None, None)),
                               resident=resident, route=c.route)
        else:
            want = fbr.k2_plan(rows, params, sms, limbs, resident=resident)
        # a wave: as many clusters as the card holds, each one tile or,
        # on the ring's paired plans, two
        clusters = -(-(-(-rows // want.cb)) // getattr(want, "pair", 1))
        assert rm.launch_plan(params, rows, kernel, limbs) == (
            want, -(-clusters // max(1, resident(want))))


# ------------------------------------------------- the H100 cost model

# (p, sq_norm1, sq_norm2, keywords): the Kreyvium-1152 probe's arguments
# and bench.py's p32 ones
STAGED = [
    (10, 27, 25, dict(weight1=8754, weight2=93, wires_from_stage2=False,
                      max_p_error=1e-7)),
    (32, 4, 2, dict(max_p_error=1e-6)),
]


def served(profile, params, bsk_limbs=4, staged=False) -> str:
    """The kernel the model prices for ``params``, checked to serve it."""
    kern = profile.kernel(params.lwe_dim, params.glwe_dim, params.poly_size,
                          params.bsk_level, params.ksk_level, bsk_limbs,
                          staged)
    assert unsupported(params, kern == "fused_otf") is None
    assert params.bsk_base_log <= 8
    assert params.ksk_base_log <= KSK_MAX_BASE_LOG
    return kern


H100_GRID = [(p, norm2, pe) for pe in [P_ERROR_4_SIGMA, 1e-7] for p in (2, 4, 8, 10, 16, 32)
             for norm2 in (1, 6, 30)]


@pytest.mark.parametrize("p,norm2,p_error", H100_GRID)
def test_h100_picks_are_served(p, norm2, p_error):
    profile = h100_profile()
    sol = optimize(p, norm2, p_error)
    assert sol is not None and sol.p_error <= p_error
    kern = served(profile, sol.params, sol.bsk_limbs)
    # the CLI's --orientation auto runs the kernel the model priced, at the
    # memory the profile was calibrated with
    cuda = torch.device("cuda")
    assert pick_orientations([sol.params], cuda, profile.k2_memory,
                             sol.bsk_limbs) == [kern]
    assert sol.cost == bootstrap_cost_us(
        sol.params.lwe_dim, sol.params.glwe_dim, sol.params.poly_size,
        sol.params.bsk_level, sol.params.ksk_level, sol.bsk_limbs)
    assert sol.params.poly_size <= 2048


@pytest.mark.parametrize("p,norm1,norm2,kw", STAGED)
def test_h100_staged_picks_run_on_k1(p, norm1, norm2, kw):
    profile = h100_profile()
    ssol = optimize_staged(p, norm1, norm2, **kw)
    assert ssol is not None
    for params in (ssol.params1, ssol.params2):
        assert served(profile, params, staged=True) == "fused_otf"
    cuda = torch.device("cuda")
    assert pick_orientations([ssol.params1, ssol.params2], cuda) \
        == ["fused_otf"] * 2


# ------------------------------------------ the JAX model's tests, mirrored

def test_predict_native_amortizes_with_batch():
    sol = optimize(4, 2)
    nlb = [3, 5, 1]
    small = rm.predict_native_us(sol, nlb, 1)
    big = rm.predict_native_us(sol, nlb, 256)
    assert big < small
    # floor: padded bootstraps at the per-boot slope
    assert big >= sum(rm.bucket(x) for x in nlb) * rm.slope_us(
        sol.params, sol.cost)


def test_predict_staged_two_calls_per_level():
    sol = optimize(4, 2)
    ssol = StagedSolution(sol.params, sol.params, 0.0, 0.0)
    one_call = rm.predict_staged_us(ssol, [(0, 4, 0)], 16)
    two_calls = rm.predict_staged_us(ssol, [(2, 2, 2)], 16)
    assert two_calls > one_call
    assert rm.predict_staged_us(ssol, [(0, 0, 0)], 16) == 0.0


def test_call_fixed_positive_and_the_sum_of_the_parts():
    sol = optimize(4, 2)
    for orient in ("fused", "fused_otf"):
        for rows in (8, 64, 1024, 8192):
            fixed = rm.call_fixed_us(sol.params, rows, orient)
            assert fixed > 0
            assert math.isclose(
                fixed + rows * rm.slope_us(sol.params, None, orient),
                rm.launch_us(sol.params, rows, orient), rel_tol=1e-12)


def test_waves_step_the_launch():
    """The kernel's part of a launch (the launch less the work around it)
    is one price for every row count of a plan and its waves, and grows
    with the waves of a plan."""
    params = shell("642,1,1024,4,6")
    a, b = rm._around(params, "fused_otf")
    kernel = {}
    for rows in range(64, 40000, 448):
        plan, waves = rm.launch_plan(params, rows, "fused_otf")
        us = rm.launch_us(params, rows, "fused_otf") \
            - (a + b * rows * (params.big_dim + 1))
        kernel.setdefault((plan, waves), set()).add(round(us, 6))
    assert len(kernel) > 3 and all(len(v) == 1 for v in kernel.values())
    for (plan, waves), us in kernel.items():
        for (plan2, waves2), us2 in kernel.items():
            if plan2 == plan and waves2 > waves:
                assert min(us2) > max(us)


def test_staged_routes_price_the_kreyvium_plan():
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    preset = STAGED_PRESETS["kreyvium_p10_staged"]
    prog = parse_lbf(PROGRAMS[1].read_text())
    routes = staged_level_routes(prog, 10)
    ssol = StagedSolution(preset.fam1, preset.fam2, 0.0, 0.0)
    us = rm.predict_staged_us(ssol, routes, 16)
    parts = sum(rm.launch_us(params, rm.launch_rows(
                    params, nbs, 16, "fused_otf"), "fused_otf")
                for ns, f1, f2 in routes
                for nbs, params in ((ns + f1, preset.fam1),
                                    (ns + f2, preset.fam2)) if nbs) / 16
    assert math.isclose(us, parts, rel_tol=1e-12) and us > 0


@pytest.mark.parametrize("p,norm2", [(2, 1), (4, 6), (8, 30), (10, 30),
                                     (16, 6), (32, 1)])
def test_every_pick_gets_a_prediction(p, norm2):
    """A family without a calibration entry takes its kernel's fit across
    families, as the JAX model takes its physics defaults."""
    sol = optimize(p, norm2, 1e-7)
    us = rm.predict_native_us(sol, [1, 100, 7], 8)
    assert math.isfinite(us) and us > 0


# ------------------------------------------------------------ the fit

def test_fit_recovers_known_constants():
    """Points made from ``kernel = F + waves·cb·sms/cluster·τ`` and
    ``around = a + b·rows·(kN+1)`` give back F, τ, a and b (least squares
    on exact data: rel_tol 1e-9)."""
    sms, F, tau, a, b = 132, 700.0, 72.9, 1500.0, 1.1e-3
    key = "642,1,1024,4,6"
    points = []
    for rows, plan, waves in ((512, [64, 4, 64], 1), (2048, [64, 2, 64], 1),
                              (8192, [64, 1, 64], 1),
                              (16384, [64, 1, 64], 2)):
        kern = F + waves * plan[0] * sms / plan[1] * tau
        around = a + b * rows * 1025
        points.append({"family": "f", "key": key, "kernel": "fused_otf",
                       "rows": rows, "plan": plan, "waves": waves,
                       "kernel_ms": kern / 1e3,
                       "step_ms": (kern + around) / 1e3,
                       "around_ms": around / 1e3})
    raw = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "device": "h100",
           "sms": sms, "k2_memory": 80e9, "resident": {}, "points": points,
           "generic": dict(points[0], kernel="generic", step_ms=500.0)}
    cal = calibrate.fit(raw)
    e = cal["families"][f"{key}/fused_otf"]
    for got, want in ((e["fixed_us"], F), (e["tau_us"], tau),
                      (e["around_a_us"], a), (e["around_b_us"], b)):
        assert math.isclose(got, want, rel_tol=1e-9)
    assert cal["kernels"]["fused"]["families"] == []
    assert cal["profile"]["eff_otf"] == cal["profile"]["eff_fused"] \
        == e["eff"]
    assert math.isclose(e["scale"], 1.0, rel_tol=1e-9)


def test_fit_takes_the_graph_around_and_keeps_the_kernel_fit():
    """The work around the kernel is fitted from the points' ``around_ms``
    (timed alone, a one-level graph without the kernel's node) and the
    kernel entries from ``kernel_ms``: the eager ``step_ms`` moves neither
    (rel_tol 1e-9)."""
    sms, F, tau, a, b = 132, 700.0, 72.9, 300.0, 1.1e-3
    key = "642,1,1024,4,6"
    points = []
    for rows, plan, waves in ((512, [64, 4, 64], 1), (2048, [64, 2, 64], 1),
                              (8192, [64, 1, 64], 1)):
        kern = F + waves * plan[0] * sms / plan[1] * tau
        points.append({"family": "f", "key": key, "kernel": "fused_otf",
                       "rows": rows, "plan": plan, "waves": waves,
                       "kernel_ms": kern / 1e3,
                       "step_ms": (kern + 5 * a) / 1e3,
                       "around_ms": (a + b * rows * 1025) / 1e3})
    raw = {"card": "NVIDIA H100 80GB HBM3, 700.00 W", "device": "h100",
           "sms": sms, "k2_memory": 80e9, "resident": {}, "points": points,
           "generic": dict(points[0], kernel="generic", step_ms=500.0)}
    graph = calibrate.fit(raw)
    e = graph["families"][f"{key}/fused_otf"]
    for got, want in ((e["fixed_us"], F), (e["tau_us"], tau),
                      (e["around_a_us"], a), (e["around_b_us"], b),
                      (graph["around"]["around_a_us"], a),
                      (graph["around"]["around_b_us"], b)):
        assert math.isclose(got, want, rel_tol=1e-9)
    for pt in points:
        pt["step_ms"] *= 3
    again = calibrate.fit(raw)
    assert again["families"] == graph["families"]
    assert again["kernels"] == graph["kernels"]
    assert again["around"] == graph["around"]


def test_time_point_times_the_work_around_the_kernel_alone(monkeypatch):
    """A point's ``around_ms`` is timed with the kernel left out: the fused
    blind rotation runs only in the warm-up and the timed steps (on the
    CPU the work around it is ``ex.step`` with the kernel's call left
    out; on the card a one-level graph's replay), and no graph is kept."""
    from tfhe_fbs_map_tpu_torch.ops import blind_rotate as br
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
    keys = generate_keys(TEST_PARAMS, seed=0, device=CPU)
    ex = CircuitExecutor(chain_program(2, 2), keys,
                         fast_keys=prepare_fast_keys(keys, "fused_otf"))
    calls, inner = [], br.blind_rotate_fused

    def counted(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(br, "blind_rotate_fused", counted)
    pt = calibrate.time_point(ex, 2, 2, reps=2)
    assert len(calls) == 1 + 2 * pt["iters"]
    assert pt["kernel_ms"] > 0 and len(pt["all_around_ms"]) == 2
    assert pt["around_ms"] == statistics.median(pt["all_around_ms"]) > 0
    assert br.blind_rotate_fused is counted
    assert len(ex.levels) == 1 and ex._graphs == {}


def test_validate_rows():
    res = {"staged": False, "orientation": "fused", "batch": 8,
           "bootstraps": 20759, "run_s": 10.0, "predicted_run_s": 9.0}
    row = validate.row("aes", res)
    assert row["ratio"] == 0.9 and row["within"]
    assert not validate.row("x", dict(res, predicted_run_s=14.0))["within"]
    assert validate.row("x", dict(res, predicted_run_s=None))["ratio"] \
        is None
    assert "| aes | False | fused | 8 | 20759 | 10.000 | 9.000 | 0.900 " \
        "| True |" in validate.table([row])


def test_cpu_executor_has_no_prediction_without_kernels():
    ex = CircuitExecutor(chain_program(2, 2),
                         generate_keys(TEST_PARAMS.with_p(8), seed=0,
                                       device=CPU))
    assert predicted_run_s(ex, ["generic"], 4, 8) is None
    got = predicted_run_s(ex, ["fused_otf"], 4, 8)
    want = rm.predict_native_us(Solution(ex.params, 0.0, 0.0, 4),
                                [lv.wire_idx.shape[0] for lv in ex.levels],
                                8, "fused_otf")
    assert got == want * 8 / 1e6
