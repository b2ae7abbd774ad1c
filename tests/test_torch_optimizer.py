"""The port's parameter optimizer against the JAX package's.

The noise model is bitwise equal; the searches under a device profile built
from the JAX module's constants give the JAX solutions field for field
(params, cost, p_error, bsk_limbs), the presets among them.  Under the
shipped H100 profile every pick is served by the CUDA kernel the cost model
prices (``tests/test_torch_runtime_model.py`` walks its picks), and the
command line prints the JAX row format.  Every value is
compared with ``==``: no tolerance."""

import json
import math
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest

import tfhe_fbs_map_tpu.optimizer.noise as JN
import tfhe_fbs_map_tpu.optimizer.optimizer as JO
import tfhe_fbs_map_tpu_torch.optimizer as TPKG
import tfhe_fbs_map_tpu_torch.optimizer.noise as TN
import tfhe_fbs_map_tpu_torch.optimizer.optimizer as TO
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import pick_kernel
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, STAGED_PRESETS

ROOT = Path(__file__).resolve().parents[1]

# the JAX module's TPU model as a profile: K2's matrices may take its HBM
# budget with no headroom, every int8-digit candidate is served
JAX_PROFILE = TO.DeviceProfile(
    name="jax", int8_ops=JO.MXU_INT8_OPS, mem_bytes=JO.HBM_BYTES,
    eff_fused=JO.MXU_EFF_FUSED, eff_otf=JO.MXU_EFF_OTF,
    k2_memory=JO.MATMUL_HBM_BUDGET, k2_headroom=0,
    generic_slowdown=JO.GENERIC_PATH_SLOWDOWN, cuda_kernels=False)

P_ERRORS = [JN.P_ERROR_4_SIGMA, 1e-7]
GRID = [(p, norm2, pe) for pe in P_ERRORS for p in (2, 3, 4, 8, 10, 16)
        for norm2 in (1, 6, 30)]
# (p, sq_norm1, sq_norm2, keywords): the Kreyvium-1152 probe's arguments
# (tfhe/params.py), bench.py's p32 ones, and the Kreyvium ones on the
# kN=2048 master
STAGED = [
    (10, 27, 25, dict(weight1=8754, weight2=93, wires_from_stage2=False,
                      max_p_error=1e-7)),
    (32, 4, 2, dict(max_p_error=1e-6)),
    (10, 27, 25, dict(weight1=8754, weight2=93, wires_from_stage2=False,
                      max_p_error=1e-7, big_dim=2048)),
]


def same_solution(got, want) -> None:
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got.params) == vars(want.params)
        assert (got.cost, got.p_error, got.bsk_limbs) == (
            want.cost, want.p_error, want.bsk_limbs)


def same_staged(got, want) -> None:
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got.params1) == vars(want.params1)
        assert vars(got.params2) == vars(want.params2)
        assert (got.cost, got.p_error) == (want.cost, want.p_error)


# -------------------------------------------------------------- noise

NOISE_GRID = [(n, k, N, l, b) for n in (450, 642, 1090) for k, N in
              ((1, 1024), (2, 512), (1, 4096)) for l in (1, 3, 5)
              for b in (2, 5, 8, 12)]


@pytest.mark.parametrize("n,k,N,l,b", NOISE_GRID)
def test_noise_terms_bitwise(n, k, N, l, b):
    for std in (0.0, 2.0, 120.42574176176474, 79078.61592281985):
        assert TN.var_blind_rotate(n, k, N, l, b, std) \
            == JN.var_blind_rotate(n, k, N, l, b, std)
        assert TN.var_keyswitch(k, N, l, b, std) \
            == JN.var_keyswitch(k, N, l, b, std)
    assert TN.var_modswitch(n, N) == JN.var_modswitch(n, N)
    for drop in (0, 1, 2):
        assert TN.var_bsk_quantization(n, k, N, l, b, drop) \
            == JN.var_bsk_quantization(n, k, N, l, b, drop)
    for p, norm2 in ((2, 1), (4, 6), (10, 30), (32, 300)):
        for drop in (0, 1):
            args = (p, norm2, n, k, N, l, b, 6, 2, 79078.6, 120.4)
            assert TN.p_error_atomic(*args, dropped_limbs=drop) \
                == JN.p_error_atomic(*args, dropped_limbs=drop)
        v = JN.var_blind_rotate(n, k, N, l, b, 120.4) * norm2
        assert TN.p_error_from_var(p, v) == JN.p_error_from_var(p, v)


@pytest.mark.parametrize("p", [8, 10, 16, 32, 64])
@pytest.mark.parametrize("from2", [True, False])
def test_staged_p_errors_bitwise(p, from2):
    args = (p, 27.0, 25.0, 642, 1, 1024, 4, 5, 6, 2, 2, 512, 4, 5, 3, 4,
            79078.6, 120.4, 120.4)
    assert TN.staged_p_errors(*args, wires_from_stage2=from2) \
        == JN.staged_p_errors(*args, wires_from_stage2=from2)
    assert TN.P_ERROR_4_SIGMA == JN.P_ERROR_4_SIGMA
    assert TN.p_error_from_var(p, 0.0) == JN.p_error_from_var(p, 0.0) == 0.0


# ------------------------------------------- parity under the JAX profile

@pytest.mark.parametrize("n,k,N", [(450, 1, 1024), (578, 2, 512),
                                   (642, 1, 2048), (1090, 4, 512),
                                   (706, 1, 4096), (1090, 2, 2048)])
def test_bootstrap_cost_equals_jax(n, k, N):
    for br_l in range(1, 5):
        for ks_l in (1, 4, 8):
            for limbs in (3, 4):
                assert TO.bootstrap_cost_us(n, k, N, br_l, ks_l, limbs,
                                            JAX_PROFILE) \
                    == JO.bootstrap_cost_us(n, k, N, br_l, ks_l, limbs)


@pytest.mark.parametrize("p,norm2,p_error", GRID)
def test_optimize_equals_jax(p, norm2, p_error):
    want = JO.optimize(p, norm2, p_error)
    got = TO.optimize(p, norm2, p_error, profile=JAX_PROFILE)
    assert want is not None
    same_solution(got, want)
    assert TO.format_solution_line(got) == JO.format_solution_line(want)


def test_generic_fallback_equals_jax(monkeypatch):
    """Where the fast search finds nothing, the generic search's pick at the
    device's slowdown (no grid point of the JAX model gets there, so the
    fast search is cut off in both modules)."""
    for mod in (JO, TO):
        inner = mod._optimize_inner

        def no_fast(*args, _inner=inner):
            return None if args[3] else _inner(*args)
        monkeypatch.setattr(mod, "_optimize_inner", no_fast)
    want = JO.optimize(8, 6)
    got = TO.optimize(8, 6, profile=JAX_PROFILE)
    same_solution(got, want)
    generic = JO._optimize_inner(8, 6, JN.P_ERROR_4_SIGMA, False)
    assert want.cost == generic.cost * JO.GENERIC_PATH_SLOWDOWN
    assert want.bsk_limbs == 4
    assert TO.optimize(4096, 1, profile=JAX_PROFILE) is None
    assert JO.optimize(4096, 1) is None


@pytest.mark.parametrize("p,norm1,norm2,kw", STAGED)
def test_optimize_staged_equals_jax(p, norm1, norm2, kw):
    want = JO.optimize_staged(p, norm1, norm2, **kw)
    assert want is not None
    same_staged(TO.optimize_staged(p, norm1, norm2, profile=JAX_PROFILE,
                                   **kw), want)


def test_optimize_staged_refuses_what_jax_refuses():
    for p in (7, 6, 9):
        assert TO.optimize_staged(p, profile=JAX_PROFILE) is None
        assert JO.optimize_staged(p) is None


def test_presets_are_the_ports_own_picks():
    """Under the JAX profile the port's searches reproduce the pinned
    presets: ``aes128_p4`` and both staged ones."""
    sol = TO.optimize(4, 6, 1e-7, profile=JAX_PROFILE)
    params, p_error = PRESETS["aes128_p4"]
    assert vars(sol.params) == vars(params) and sol.p_error == p_error
    assert sol.bsk_limbs == 4
    for name, (p, norm1, norm2, kw) in (("kreyvium_p10_staged", STAGED[0]),
                                        ("p32_staged", STAGED[1])):
        ssol = TO.optimize_staged(p, norm1, norm2, profile=JAX_PROFILE, **kw)
        preset = STAGED_PRESETS[name]
        assert vars(ssol.params1) == vars(preset.fam1)
        assert vars(ssol.params2) == vars(preset.fam2)
        assert ssol.p_error == preset.p_error


# ------------------------------------------------------ the H100 profile

def test_h100_profile_never_prices_an_unserved_kernel():
    """At N=4096 (the last GLWE shape of the native search) K2's matrices
    do not fit, so the model prices K1, which serves it (``K1_MAX_N``);
    above K1's limit (N=8192) the priced K1 serves nothing and the
    candidate is not served; under the JAX profile it is."""
    profile = TO.h100_profile()
    params = PRESETS["p16"][0]
    big = replace(params, glwe_dim=1, poly_size=4096)
    assert profile.kernel(642, 1, 4096, 3) == "fused_otf"
    assert profile.serves(big)
    huge = replace(params, glwe_dim=1, poly_size=8192)
    assert profile.kernel(642, 1, 8192, 3) == "fused_otf"
    assert not profile.serves(huge)
    assert JAX_PROFILE.serves(huge)
    assert profile.kernel(642, 1, 1024, 3, staged=True) == "fused_otf"
    assert profile.kernel(578, 2, 512, 2) == pick_kernel(
        PRESETS["aes128_p4"][0], profile.k2_memory)


def test_h100_profile_holds_no_tpu_constant():
    cal = TO.calibration()
    prof = TO.h100_profile()
    assert vars(prof) == cal["profile"]
    assert (prof.int8_ops, prof.mem_bytes) == (1979e12, 3.35e12)
    assert 0 < prof.eff_fused < 1 and 0 < prof.eff_otf < 1
    assert prof.generic_slowdown > 1 and prof.cuda_kernels
    assert "H100" in cal["card"] and re.search(r"\d W$", cal["card"])
    pkg = ROOT / "tfhe_fbs_map_tpu_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        for tpu in ("394e12", "820e9", "12e9", "MXU_", "calibration.json"):
            assert tpu not in text, (path, tpu)


def test_cli_prints_the_jax_row():
    res = subprocess.run(
        [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.optimizer",
         "--precision", "4", "--sq-norm2", "6", "--p-error", "1e-7"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert len(lines) == 1
    sol = TO.optimize(4, 6, 1e-7)
    assert lines[0] == TO.format_solution_line(sol)
    # k, N, n, l,b, l,b, cost, p_error as the JAX package prints them
    assert re.fullmatch(r"  \d+, \d+, \d+, \d+,\d+, \d+,\d+, \d+, "
                        r"\d\.\de-\d\d", lines[0])
    jax_row = JO.format_solution_line(JO.optimize(4, 6, 1e-7))
    assert lines[0].split(",")[:7] == jax_row.split(",")[:7]


def test_package_exports():
    assert TPKG.optimize is TO.optimize
    assert TPKG.P_ERROR_4_SIGMA == JN.P_ERROR_4_SIGMA
    assert math.isfinite(TPKG.bootstrap_cost_us(578, 2, 512, 2, 6))
    assert json.loads(json.dumps(TO.calibration()["profile"]))
