"""The port's native (C++) optimizer against its Python search and the JAX
package's.

Under the shipped H100 profile the native ``optimize_native`` /
``optimize_staged_native`` return the port's Python ``optimize`` /
``optimize_staged`` solutions field for field, floats included; under the
JAX-constants profile they return the JAX package's (its Python search
exactly, its native core within its own tolerance).  The native model
functions equal ``optimizer/noise.py``, ``bootstrap_cost_us`` and
``DeviceProfile.serves`` point by point, so no compensating pair of errors
hides behind equal solutions.  The library is built with ``g++`` at first
use; the tests skip only where there is none."""

import copy
import ctypes
import math
import shutil
from dataclasses import replace

import pytest

import tfhe_fbs_map_tpu.optimizer.native as JNAT
import tfhe_fbs_map_tpu.optimizer.optimizer as JO
import tfhe_fbs_map_tpu_torch.ops.fused_blind_rotate as fbr
import tfhe_fbs_map_tpu_torch.optimizer.native as NAT
import tfhe_fbs_map_tpu_torch.optimizer.noise as TN
import tfhe_fbs_map_tpu_torch.optimizer.optimizer as TO
import tfhe_fbs_map_tpu_torch.optimizer.runtime_model as RM
from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native core")

# the JAX module's TPU model as a profile (tests/test_torch_optimizer.py)
JAX_PROFILE = TO.DeviceProfile(
    name="jax", int8_ops=JO.MXU_INT8_OPS, mem_bytes=JO.HBM_BYTES,
    eff_fused=JO.MXU_EFF_FUSED, eff_otf=JO.MXU_EFF_OTF,
    k2_memory=JO.MATMUL_HBM_BUDGET, k2_headroom=0,
    generic_slowdown=JO.GENERIC_PATH_SLOWDOWN, cuda_kernels=False)

# (p, sq_norm2, max_p_error): tests/test_native_optimizer.py's grid, p=22
# at the sweep's s9234r norm, and the runtime CLI's bit-exact target
P4 = TN.P_ERROR_4_SIGMA
GRID = [(2, 2, P4), (4, 10, P4), (8, 20, P4), (16, 50, P4), (32, 5, P4),
        (22, 26, P4), (22, 26, 1e-7), (4, 6, 1e-7), (3, 6, 1e-7)]
# (p, sq_norm1, sq_norm2, keywords): tests/test_native_optimizer.py's
# staged cases, and the runtime CLI's search for s9234r mapped at p=22 (its
# probe: norms 1 and 26, all 280 nodes routed to fam2) at 1e-7 on both
# masters
STAGED = [(32, 4.0, 2.0, {}), (16, 4.0, 2.0, {}), (32, 340.0, 257.0, {}),
          (20, 9.0, 3.0, {}), (10, 6.0, 3.0, dict(weight1=40, weight2=4000)),
          (32, 4.0, 2.0, dict(weight1=120, weight2=700)),
          (22, 1.0, 26.0, dict(max_p_error=1e-7, weight1=0, weight2=280)),
          (22, 1.0, 26.0, dict(max_p_error=1e-7, weight1=0, weight2=280,
                               big_dim=2048))]


def same(got, want) -> None:
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


def test_builds_into_the_ignored_build_directory():
    assert NAT.native_available()
    path = NAT.library_path()
    assert path.is_file() and path.parent == NAT.BUILD_DIR
    assert NAT.BUILD_DIR.parts[-2] == "build"


@pytest.mark.parametrize("p,norm2,p_error", GRID)
def test_native_equals_python_under_h100(p, norm2, p_error):
    want = TO.optimize(p, norm2, p_error)
    assert want is not None
    same(NAT.optimize_native(p, norm2, p_error), want)


@pytest.mark.parametrize("p,n1,n2,kw", STAGED)
def test_staged_native_equals_python_under_h100(p, n1, n2, kw):
    same_staged(NAT.optimize_staged_native(p, n1, n2, **kw),
                TO.optimize_staged(p, n1, n2, **kw))


def test_s9234r_p22_staged_pick_needs_the_2048_master():
    """At 1e-7 the 1024 master has no staged pick; the 2048 one picks fam1
    at (k=1, N=2048) and fam2 at (k=2, N=1024), both on K1."""
    assert NAT.optimize_staged_native(*STAGED[-2][:3],
                                      **STAGED[-2][3]) is None
    sol = NAT.optimize_staged_native(*STAGED[-1][:3], **STAGED[-1][3])
    assert (sol.params1.lwe_dim, sol.params1.glwe_dim,
            sol.params1.poly_size) == (674, 1, 2048)
    assert (sol.params2.glwe_dim, sol.params2.poly_size) == (2, 1024)
    assert 1e-7 < sol.p_error < 1.2e-7


def test_generic_path_when_no_kernel_serves(monkeypatch):
    """A profile on which no fast candidate is served (every family priced
    on K1, and K1 capped below every N of the grid): both searches fall
    back to the generic path and scale its cost alike."""
    monkeypatch.setattr(fbr, "K1_MAX_N", 256)
    monkeypatch.setattr(NAT, "K1_MAX_N", 256)
    pr = replace(TO.h100_profile(), k2_memory=0)
    assert TO._optimize_inner(4, 6, 1e-7, True, pr) is None
    want = TO.optimize(4, 6, 1e-7, profile=pr)
    fast = TO.optimize(4, 6, 1e-7)
    assert want is not None and want.cost > 100 * fast.cost
    same(NAT.optimize_native(4, 6, 1e-7, profile=pr), want)


@pytest.mark.parametrize("p,norm2,p_error", GRID)
def test_native_equals_jax_under_jax_profile(p, norm2, p_error):
    got = NAT.optimize_native(p, norm2, p_error, profile=JAX_PROFILE)
    want = JO.optimize(p, norm2, p_error)
    same(got, TO.Solution(TFHEParams(**vars(want.params)), want.cost,
                          want.p_error, want.bsk_limbs))
    jnat = JNAT.optimize_native(p, norm2, p_error)
    assert vars(got.params) == vars(jnat.params)
    assert got.bsk_limbs == jnat.bsk_limbs
    assert abs(got.cost - jnat.cost) < 1e-6


@pytest.mark.parametrize("p,n1,n2,kw", STAGED[:6])
def test_staged_native_equals_jax_under_jax_profile(p, n1, n2, kw):
    got = NAT.optimize_staged_native(p, n1, n2, profile=JAX_PROFILE, **kw)
    want = JO.optimize_staged(p, n1, n2, **kw)
    assert (got is None) == (want is None)
    if want is not None:
        assert vars(got.params1) == vars(want.params1)
        assert vars(got.params2) == vars(want.params2)
        assert (got.cost, got.p_error) == (want.cost, want.p_error)


NOISE_GRID = [(n, k, N, l, b) for n in (450, 1066)
              for k, N in ((1, 1024), (2, 512), (1, 2048), (4, 512),
                           (1, 4096))
              for l, b in ((1, 8), (2, 8), (3, 6), (4, 4), (5, 12))]
STDS = (0.0, 2.0, 120.42574176176474, 79078.61592281985)


@pytest.mark.parametrize("n,k,N,l,b", NOISE_GRID)
def test_model_functions_equal_noise_py(n, k, N, l, b):
    fns = NAT.native_model_fns()
    for std in STDS:
        assert fns["nv_var_blind_rotate"](n, k, N, l, b, std) \
            == TN.var_blind_rotate(n, k, N, l, b, std)
        assert fns["nv_var_keyswitch"](k, N, l, b, std) \
            == TN.var_keyswitch(k, N, l, b, std)
    assert fns["nv_var_modswitch"](n, N) == TN.var_modswitch(n, N)
    for drop in (0, 1, 2):
        assert fns["nv_var_bsk_quantization"](n, k, N, l, b, drop) \
            == TN.var_bsk_quantization(n, k, N, l, b, drop)
    for p, norm2, drop in ((4, 1.0, 0), (8, 25.0, 0), (4, 1.0, 1),
                           (22, 26.0, 0)):
        args = (p, norm2, n, k, N, l, b, 4, 4, STDS[3], STDS[2], drop)
        assert fns["nv_p_error_atomic"](*args) == TN.p_error_atomic(*args)
    for p in (3, 8, 16):
        for v in (0.0, 1e12, 2.5e15, math.pi * 1e17):
            assert fns["nv_p_error_from_var"](p, v) \
                == TN.p_error_from_var(p, v)


@pytest.mark.parametrize("profile", [TO.h100_profile(), JAX_PROFILE],
                         ids=["h100", "jax"])
@pytest.mark.parametrize("n,k,N,l,b", NOISE_GRID)
def test_bootstrap_cost_and_serving_equal_python(profile, n, k, N, l, b):
    """``nv_bootstrap_cost_us`` is ``bootstrap_cost_us`` under any profile
    and orientation, and ``nv_serves`` is ``DeviceProfile.serves``, K1's
    N limit included (N=4096 served, 8192 not)."""
    fns = NAT.native_model_fns()
    prof = ctypes.byref(NAT.profile_struct(profile))
    for limbs in (3, 4):
        for ks_l, code, orient in ((4, -1, None), (2, 0, "fused"),
                                   (7, 1, "fused_otf")):
            assert fns["nv_bootstrap_cost_us"](n, k, N, l, ks_l, limbs,
                                               code, prof) \
                == TO.bootstrap_cost_us(n, k, N, l, ks_l, limbs, profile,
                                        orient)
    for NN in (N, 2 * N):
        for ks_b in (4, 7, 8):
            params = TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=NN,
                                bsk_level=l, bsk_base_log=b, ksk_level=2,
                                ksk_base_log=ks_b, lwe_noise_std=0.0,
                                glwe_noise_std=0.0)
            for limbs in (3, 4):
                for staged in (False, True):
                    assert bool(fns["nv_serves"](
                        n, k, NN, l, b, 2, ks_b, limbs, staged, prof)) \
                        == profile.serves(params, limbs, staged)


# ------------------------------------------- the kernel pick, K1 against K2

@pytest.fixture()
def mixed(monkeypatch):
    """A calibration in which K1 pays 30 ms a launch, across families and
    in every family's K1 entry: the pick then takes K2 at some families of
    the native grid and K1 at others."""
    cal = copy.deepcopy(RM.calibration())
    cal["kernels"]["fused_otf"]["fixed_us"] = 30e3
    for e in cal["families"].values():
        if e["kernel"] == "fused_otf":
            e["fixed_us"] = 30e3
    monkeypatch.setattr(RM, "calibration", lambda: cal)
    return cal


def shell(n, k, N, l, ks_l) -> TFHEParams:
    return TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=1, ksk_level=ks_l, ksk_base_log=1,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def test_priced_shapes_hold_every_shape_the_searches_walk():
    staged = {(k, big // k) for big in (1024, 2048) for k in (1, 2)}
    assert set(TO.GLWE_SHAPES) | staged <= set(NAT.PRICED_SHAPES)
    assert min(N for _, N in NAT.PRICED_SHAPES) >= fbr.K1_SLICE


def test_mixed_calibration_takes_both_kernels(mixed):
    pr = TO.h100_profile()
    picks = {pr.kernel(n, k, N, l, 6) for k, N in TO.GLWE_SHAPES
             for n in (450, 578, 1066) for l in (1, 2, 4)}
    assert picks == {"fused", "fused_otf"}


@pytest.mark.parametrize("p,norm2,p_error", GRID)
def test_native_equals_python_under_a_mixed_pick(p, norm2, p_error, mixed):
    """Where the calibration sends some families to K2 and others to K1,
    the native search still returns the Python one's solution."""
    want = TO.optimize(p, norm2, p_error)
    same(NAT.optimize_native(p, norm2, p_error), want)


@pytest.mark.parametrize("calibrated", ["shipped", "mixed"])
@pytest.mark.parametrize("k,N", TO.GLWE_SHAPES)
def test_kernel_price_and_pick_equal_python(k, N, calibrated, request):
    """``nv_kernel_us`` is ``runtime_model.kernel_us`` to the bit, and
    ``nv_prices_otf`` is ``DeviceProfile.kernel``, K1 against K2, at every
    shape of the native grid, at 3 and 4 limbs."""
    if calibrated == "mixed":
        request.getfixturevalue("mixed")
    fns = NAT.native_model_fns()
    profile = TO.h100_profile()
    prof = ctypes.byref(NAT.profile_struct(profile))
    for n in (450, 578, 642, 1066):
        for l in (1, 2, 3, 4):
            for ks_l in (2, 6):
                params = shell(n, k, N, l, ks_l)
                for limbs in (3, 4):
                    for code, orient in ((0, "fused"), (1, "fused_otf")):
                        assert fns["nv_kernel_us"](
                            n, k, N, l, ks_l, limbs, code, prof) \
                            == RM.kernel_us(params, orient, limbs, profile)
                    otf = profile.kernel(n, k, N, l, ks_l, limbs)
                    assert bool(fns["nv_prices_otf"](
                        n, k, N, l, ks_l, limbs, 0, prof)) \
                        == (otf == "fused_otf")


def test_native_prices_every_calibrated_family():
    """At every family the calibration holds an entry of (at N >= 256),
    the native price and pick are the Python ones: the entries reach the
    native core."""
    fns = NAT.native_model_fns()
    profile = TO.h100_profile()
    prof = ctypes.byref(NAT.profile_struct(profile))
    seen = 0
    for key in RM.calibration()["families"]:
        n, k, N, l, ks_l = (int(x) for x in key.split("/")[0].split(","))
        if N < fbr.K1_SLICE:
            continue
        params = shell(n, k, N, l, ks_l)
        for limbs in (4, 3):
            for code, orient in ((0, "fused"), (1, "fused_otf")):
                assert fns["nv_kernel_us"](n, k, N, l, ks_l, limbs, code,
                                           prof) \
                    == RM.kernel_us(params, orient, limbs, profile)
            assert bool(fns["nv_prices_otf"](n, k, N, l, ks_l, limbs, 0,
                                             prof)) \
                == (profile.kernel(n, k, N, l, ks_l, limbs) == "fused_otf")
        seen += 1
    assert seen >= 11


# the runtime model's packed launches: one evaluation's 1 to 256, eight's,
# and Kreyvium's fam1 calls of 2,280 to 3,200 ciphertexts
PACKED_ROWS = (1, 7, 16, 97, 112, 113, 128, 200, 240, 241, 256, 320, 384,
               448, 449, 512, 576, 1000, 1088, 2304, 2952, 3008, 3200, 5000)


@pytest.mark.parametrize("name", ["aes128_p4", "anchor",
                                  "kreyvium_p10_staged.fam1",
                                  "kreyvium_p10_staged.fam2", "p8",
                                  "k=2 N=512 l=3"])
def test_native_prices_and_routes_packed_launches(name):
    """At launch sizes that are no power of two, the native core's launch
    price (``nv_launch_us``), K1's route (``nv_small_tile_wins``) and the
    packed count of a level (``nv_launch_rows``) are the runtime model's,
    to the bit, through both kernels at 3 and 4 limbs."""
    from tfhe_fbs_map_tpu_torch.optimizer import calibrate
    params = {**calibrate.families(), **calibrate.fit_families()}[name][0]
    fns = NAT.native_model_fns()
    prof = ctypes.byref(NAT.profile_struct(TO.h100_profile()))
    fam = (params.lwe_dim, params.glwe_dim, params.poly_size,
           params.bsk_level, params.ksk_level)
    routes = set()
    for limbs in (4, 3):
        for code, orient in ((0, "fused"), (1, "fused_otf")):
            for rows in PACKED_ROWS:
                assert fns["nv_launch_us"](*fam, limbs, code, rows, prof) \
                    == RM.launch_us(params, rows, orient, limbs)
                if code:
                    wins = RM.small_tile_wins(params, rows, limbs)
                    assert bool(fns["nv_small_tile_wins"](
                        *fam, limbs, rows, prof)) == wins
                    routes.add(wins)
            for real in (1, 3, 14, 57, 100, 129, 285, 369, 399):
                for v in (1, 3, 8, 32):
                    assert fns["nv_launch_rows"](*fam, limbs, code, real, v,
                                                 prof) \
                        == RM.launch_rows(params, real, v, orient, limbs)
    assert routes == ({False} if params.poly_size > 512 else {True, False})


@pytest.mark.parametrize("scale", [700.0, 1e3, 1.3e3])
def test_native_prices_the_small_tile_route(monkeypatch, scale):
    """Where a family has calibrated points of K1's small-tile plan (a
    ``.../k1s`` entry; here one at every calibrated N = 512 family, its
    kernel µs growing with the launch so that it wins some launch sizes and
    loses others),
    ``nv_kernel_us`` takes, launch size by launch size, the lower of its
    kernel term and the ring kernel's, as ``runtime_model.kernel_us`` does:
    to the bit, at 3 and 4 limbs, and the pick follows."""
    cal = copy.deepcopy(RM.calibration())
    for key, e in list(cal["families"].items()):
        fam, kern = key.split("/")
        if kern == "fused_otf" and int(fam.split(",")[2]) == 512:
            cal["families"][f"{fam}/k1s"] = {
                "name": e["name"], "kernel": "k1s", "fixed_us": 500.0,
                "scale": 1.0, "around_a_us": 0.0, "around_b_us": 0.0,
                "points": [[r, 5e3 + scale * r ** 0.5]
                           for r in RM.SMALL_ROWS]}
    monkeypatch.setattr(RM, "calibration", lambda: cal)
    fns = NAT.native_model_fns()
    profile = TO.h100_profile()
    prof = ctypes.byref(NAT.profile_struct(profile))
    routes = set()
    for key in cal["families"]:
        fam, kern = key.split("/")
        if kern != "k1s":
            continue
        n, k, N, l, ks_l = (int(x) for x in fam.split(","))
        params = shell(n, k, N, l, ks_l)
        for limbs in (4, 3):
            routes |= {RM.small_tile_wins(params, r, limbs)
                       for r in RM.ROWS}
            for code, orient in ((0, "fused"), (1, "fused_otf")):
                assert fns["nv_kernel_us"](n, k, N, l, ks_l, limbs, code,
                                           prof) \
                    == RM.kernel_us(params, orient, limbs, profile)
            assert bool(fns["nv_prices_otf"](n, k, N, l, ks_l, limbs, 0,
                                             prof)) \
                == (profile.kernel(n, k, N, l, ks_l, limbs) == "fused_otf")
    assert routes == {True, False}
