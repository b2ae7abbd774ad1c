"""ctypes binding of the port's native (C++) optimizer core.

``optimizer/csrc/optimizer.cpp`` is the C++ counterpart of
:mod:`.optimizer`, as ``native/optimizer.cpp`` is the JAX package's: the
same grids, order and pruning, and the serving rules of the CUDA kernels.
It takes the :class:`DeviceProfile` as an argument, with what
:mod:`.runtime_model` prices a launch by (every plan each kernel may
launch at the shapes of :data:`PRICED_SHAPES` with the clusters of it the
calibrated card runs at once, the kernels' fits and the families'
entries, and K1's small-tile plan: the families' points and plans by
waves, and its fit across families with the shapes it serves), so one
build prices any card, and a launch of any size: :func:`.runtime_model.
kernel_us`, ``launch_us``, ``launch_rows`` and ``small_tile_wins``.  It is
built
with ``g++`` at first use into the git-ignored
``build/tfhe_fbs_map_tpu_torch/`` beside the package (the library's name
carries a hash of the source and flags) and is host code: no device runs it.
:func:`optimize_native` and :func:`optimize_staged_native` return what
:func:`.optimizer.optimize` and :func:`.optimizer.optimize_staged` return
(``tests/test_torch_native_optimizer.py``); the sweep
(:mod:`..harness.sweep`) prices its rows through them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from ..ops.blind_rotate import KSK_MAX_BASE_LOG
from ..ops import fused_blind_rotate as fbr
from ..ops.fused_blind_rotate import (K1_MAX_N, K1_SLICE, K1S_MAX_KN,
                                      K2_CHUNK, K2_KC, k1s_clusters)
from ..tfhe.params import TFHEParams
from . import runtime_model
from .noise import P_ERROR_4_SIGMA
from .optimizer import DeviceProfile, Solution, StagedSolution, h100_profile

__all__ = ["native_available", "native_model_fns", "optimize_native",
           "optimize_staged_native", "profile_struct", "PRICED_SHAPES"]

# The (k, N) shapes whose launch plans the native core is handed: every
# shape the searches walk (``GLWE_SHAPES``, the staged shapes) and their
# neighbours, at N >= K1_SLICE, where a plan does not depend on l.
PRICED_SHAPES = tuple((k, N) for k in (1, 2, 3, 4)
                      for N in (256, 512, 1024, 2048, 4096, 8192))
# the kernels by the native core's index
KERNELS = ("fused", "fused_otf")
# the gadget levels l up to which the native core is told the shapes K1's
# small-tile plan serves (the searches walk l up to 5)
SERVED_LEVELS = 8

SRC = Path(__file__).resolve().parent / "csrc" / "optimizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "tfhe_fbs_map_tpu_torch"
# -ffp-contract=off: a fused multiply-add would round once where Python
# rounds twice, and the floats must be the Python search's bits
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lib = None

i32, f64 = ctypes.c_int32, ctypes.c_double
I32P, F64P = ctypes.POINTER(i32), ctypes.POINTER(f64)


class _CProfile(ctypes.Structure):
    _fields_ = [
        ("int8_ops", f64), ("mem_bytes", f64), ("eff_fused", f64),
        ("eff_otf", f64), ("k2_memory", f64), ("k2_headroom", f64),
        ("k1_pair_cost", f64),
        ("cuda_kernels", i32), ("k1_slice", i32), ("k1_max_n", i32),
        ("k1s_max_kn", i32), ("k2_kc", i32), ("k2_chunk", i32),
        ("ksk_max_base_log", i32), ("sms", i32),
        ("n_rows", i32), ("rows", I32P), ("n_ring", i32), ("ring", I32P),
        ("n_k2", i32), ("k2", I32P), ("n_tiles", i32), ("tiles", I32P),
        ("fixed_us", f64 * 2), ("scale", f64 * 2), ("pair_scale", f64 * 2),
        ("around_a_us", f64),
        ("around_b_us", f64), ("n_entries", i32), ("entry_keys", I32P),
        ("entry_fits", F64P), ("n_small", i32), ("small_keys", I32P),
        ("n_points", i32), ("point_keys", I32P), ("point_us", F64P),
        ("n_plans", i32), ("plans", I32P), ("plan_waves", I32P),
        ("plan_us", F64P), ("n_fit", i32), ("fit_rows", I32P),
        ("fit_step_us", F64P), ("fit_scale", F64P), ("n_shape_fit", i32),
        ("shape_fit_keys", I32P), ("shape_fit_step", F64P),
        ("n_served", i32), ("served", I32P),
    ]


class _CSolution(ctypes.Structure):
    _fields_ = [
        ("lwe_dim", i32), ("glwe_dim", i32), ("poly_size", i32),
        ("bsk_level", i32), ("bsk_base_log", i32), ("ksk_level", i32),
        ("ksk_base_log", i32), ("lwe_noise_std", f64),
        ("glwe_noise_std", f64), ("cost_us", f64), ("p_error", f64),
        ("bsk_limbs", i32),
    ]


class _CStagedSolution(ctypes.Structure):
    _fields_ = [
        ("p1", i32), ("n", i32), ("k1", i32), ("N1", i32), ("bl1", i32),
        ("bb1", i32), ("kl1", i32), ("kb1", i32),
        ("p2", i32), ("k2", i32), ("N2", i32), ("bl2", i32), ("bb2", i32),
        ("kl2", i32), ("kb2", i32),
        ("lwe_noise_std", f64), ("glwe1_noise_std", f64),
        ("glwe2_noise_std", f64), ("cost_us", f64), ("p_error", f64),
    ]


_PROFILE = ctypes.POINTER(_CProfile)
# the exported model functions' arguments (each returns a double, but
# those of _INT_FNS an int)
_MODEL_FNS = {
    "nv_var_blind_rotate": [i32, i32, i32, i32, i32, f64],
    "nv_var_keyswitch": [i32, i32, i32, i32, f64],
    "nv_var_modswitch": [i32, i32],
    "nv_var_bsk_quantization": [i32, i32, i32, i32, i32, i32],
    "nv_p_error_atomic": [i32, f64, i32, i32, i32, i32, i32, i32, i32, f64,
                          f64, i32],
    "nv_p_error_from_var": [i32, f64],
    "nv_bootstrap_cost_us": [i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_serves": [i32, i32, i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_kernel_us": [i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_prices_otf": [i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_launch_us": [i32, i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_launch_rows": [i32, i32, i32, i32, i32, i32, i32, i32, i32,
                       _PROFILE],
    "nv_small_tile_wins": [i32, i32, i32, i32, i32, i32, i32, _PROFILE],
}
# the model functions that return an int
_INT_FNS = ("nv_serves", "nv_prices_otf", "nv_launch_rows",
            "nv_small_tile_wins")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"liboptimizer_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        # build under a name of this process's, then rename: concurrent
        # first uses (test workers) each see a whole library or none
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.optimize_params.restype = i32
    lib.optimize_params.argtypes = [i32, f64, f64, i32, _PROFILE,
                                    ctypes.POINTER(_CSolution)]
    lib.optimize_staged_params.restype = i32
    lib.optimize_staged_params.argtypes = [
        i32, f64, f64, f64, i32, i32, f64, f64, _PROFILE,
        ctypes.POINTER(_CStagedSolution)]
    for name, argtypes in _MODEL_FNS.items():
        fn = getattr(lib, name)
        fn.restype = i32 if name in _INT_FNS else f64
        fn.argtypes = argtypes
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library builds (a ``g++`` is on the path) and loads."""
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


def native_model_fns() -> dict:
    """The native model functions one by one (the lockstep tests)."""
    lib = _load()
    return {name: getattr(lib, name) for name in _MODEL_FNS}


def _array(ctype, values):
    return (ctype * len(values))(*values)


def _shell(k: int, N: int, l: int = 1, n: int = 1,
           ks_l: int = 1) -> TFHEParams:
    return TFHEParams(p=2, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=1, ksk_level=ks_l, ksk_base_log=1,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def profile_struct(profile: DeviceProfile) -> _CProfile:
    """``profile``, the CUDA kernels' serving limits and the calibration's
    prices as the C struct (it holds its arrays)."""
    cal = runtime_model.calibration()
    sms, table = cal["sms"], cal["resident"]
    rows = runtime_model.ROWS

    def resident(orientation, limbs, plan, params=None):
        return table.get(runtime_model.resident_key(orientation, limbs, plan,
                                                    params),
                         sms // plan.cluster)

    # every plan each kernel may launch at the shapes priced, with the
    # clusters of it the card runs at once
    ring, k2, tiles = [], [], []
    for k, N in PRICED_SHAPES:
        shell = _shell(k, N)
        for limbs in (3, 4):
            for t in fbr.K1_TILES:
                for w in fbr.K1_WIDTHS:
                    if fbr.k1_fits(t, w, limbs):
                        for c in fbr.k1_clusters(shell, w):
                            for pair in fbr.K1_PAIRS:
                                ring += [k, N, limbs, t, c, w, pair,
                                         resident("fused_otf", limbs,
                                                  fbr.K1Plan(t, c, w,
                                                             pair))]
            for t in fbr.K2_TILES:
                for c in fbr.k2_clusters(shell):
                    k2 += [k, N, limbs, t, c,
                           resident("fused", limbs,
                                    fbr.K2Plan(t, c, 0, 0, 0)),
                           max(t, fbr.K2_ROWS) + limbs * K2_CHUNK]
            for l in range(1, SERVED_LEVELS + 1):
                shell_l = _shell(k, N, l)
                for t in fbr.K1S_WIDE_TILES:
                    for c in fbr.k1s_clusters(shell_l, limbs, t):
                        plan = fbr._k1s_plan(shell_l, limbs, c, t)
                        tiles += [k, N, l, limbs, t, c, resident(
                            "fused_otf", limbs, plan, shell_l)]
    keys, fits = [], []
    for key, e in cal["families"].items():
        if e["kernel"] in KERNELS:
            keys += [int(x) for x in key.split("/")[0].split(",")]
            keys.append(KERNELS.index(e["kernel"]))
            fits += [e["fixed_us"], e["scale"], e["around_a_us"],
                     e["around_b_us"],
                     e.get("pair_scale", cal["kernels"][e["kernel"]].get(
                         "pair_scale", 2.0))]
    # K1's small-tile plan: the families with its entry, in the
    # calibration's order, their points and the ring's beside them, and
    # their plans by waves where timed
    skeys, pkeys, pus, plans, pwaves, plan_us = [], [], [], [], [], []
    for key, e in cal["families"].items():
        if e["kernel"] != "k1s":
            continue
        f = len(skeys) // 5
        fam = key.split("/")[0]
        skeys += [int(x) for x in fam.split(",")]
        ring_pts = cal["families"].get(f"{fam}/fused_otf", {}).get(
            "points", [])
        for kind, pts in ((0, e["points"]), (1, ring_pts)):
            for r, us in pts:
                pkeys += [f, r, kind]
                pus.append(us)
        for t, c, res, by_waves in e.get("plans", ()):
            plans += [f, t, c, res, len(pwaves), len(by_waves)]
            pwaves += [w for w, _ in by_waves]
            plan_us += [us for _, us in by_waves]
    # its fit across families (and at each shape timed), and the (k, N, l)
    # it serves at 3 and 4 limbs of the (k, N) timed
    wide = cal["kernels"].get("k1s_wide", {"rows": [], "step_us": [],
                                           "scale": [], "shapes": {},
                                           "rings": []})
    shape_keys, shape_steps = [], []
    for key, steps in wide["shapes"].items():
        k1, N, l = (int(x) for x in key.split("x"))
        shape_keys += [k1 - 1, N, l]
        shape_steps += steps
    served = []
    for k, N in PRICED_SHAPES:
        for l in range(1, SERVED_LEVELS + 1):
            if [k, N] in wide["rings"] and all(
                    k1s_clusters(_shell(k, N, l), limbs)
                    for limbs in (3, 4)):
                served += [k, N, l]
    fit = [cal["kernels"][o] for o in KERNELS]
    return _CProfile(
        profile.int8_ops, profile.mem_bytes, profile.eff_fused,
        profile.eff_otf, profile.k2_memory, profile.k2_headroom,
        fbr.K1_PAIR_COST, int(profile.cuda_kernels), K1_SLICE, K1_MAX_N, K1S_MAX_KN, K2_KC,
        K2_CHUNK, KSK_MAX_BASE_LOG, sms, len(rows), _array(i32, rows),
        len(ring) // 8, _array(i32, ring), len(k2) // 7, _array(i32, k2),
        len(tiles) // 7, _array(i32, tiles),
        (f64 * 2)(*(f["fixed_us"] for f in fit)),
        (f64 * 2)(*(f.get("scale", 1.0) for f in fit)),
        (f64 * 2)(*(f.get("pair_scale", 2.0) for f in fit)),
        cal["around"]["around_a_us"], cal["around"]["around_b_us"],
        len(keys) // 6, _array(i32, keys), _array(f64, fits),
        len(skeys) // 5, _array(i32, skeys), len(pus), _array(i32, pkeys),
        _array(f64, pus), len(plans) // 6, _array(i32, plans),
        _array(i32, pwaves), _array(f64, plan_us),
        len(wide["rows"]), _array(i32, wide["rows"]),
        _array(f64, wide["step_us"]), _array(f64, wide["scale"]),
        len(shape_keys) // 3, _array(i32, shape_keys),
        _array(f64, shape_steps), len(served) // 3, _array(i32, served))


def optimize_native(p: int, sq_norm2: float,
                    max_p_error: float = P_ERROR_4_SIGMA,
                    profile: DeviceProfile | None = None) -> Solution | None:
    """:func:`.optimizer.optimize` in C++: the fast-path search, then, where
    it finds nothing, the generic path's, its cost scaled by the profile's
    ``generic_slowdown``."""
    pr = profile or h100_profile()
    lib = _load()
    prof = profile_struct(pr)
    out = _CSolution()
    slowdown = 1.0
    ok = lib.optimize_params(p, float(sq_norm2), float(max_p_error), 1,
                             ctypes.byref(prof), ctypes.byref(out))
    if not ok:
        ok = lib.optimize_params(p, float(sq_norm2), float(max_p_error), 0,
                                 ctypes.byref(prof), ctypes.byref(out))
        slowdown = pr.generic_slowdown
    if not ok:
        return None
    params = TFHEParams(
        p=p, lwe_dim=out.lwe_dim, glwe_dim=out.glwe_dim,
        poly_size=out.poly_size, bsk_level=out.bsk_level,
        bsk_base_log=out.bsk_base_log, ksk_level=out.ksk_level,
        ksk_base_log=out.ksk_base_log, lwe_noise_std=out.lwe_noise_std,
        glwe_noise_std=out.glwe_noise_std)
    return Solution(params, out.cost_us * slowdown, out.p_error,
                    out.bsk_limbs)


def optimize_staged_native(p: int, sq_norm1: float = 4.0,
                           sq_norm2: float = 2.0,
                           max_p_error: float = P_ERROR_4_SIGMA,
                           big_dim: int = 1024,
                           wires_from_stage2: bool = True,
                           weight1: float = 1.0, weight2: float = 1.0,
                           profile: DeviceProfile | None = None
                           ) -> StagedSolution | None:
    """:func:`.optimizer.optimize_staged` in C++."""
    pr = profile or h100_profile()
    lib = _load()
    prof = profile_struct(pr)
    out = _CStagedSolution()
    ok = lib.optimize_staged_params(
        p, float(sq_norm1), float(sq_norm2), float(max_p_error), big_dim,
        1 if wires_from_stage2 else 0, float(weight1), float(weight2),
        ctypes.byref(prof), ctypes.byref(out))
    if not ok:
        return None
    pr1 = TFHEParams(p=out.p1, lwe_dim=out.n, glwe_dim=out.k1,
                     poly_size=out.N1, bsk_level=out.bl1,
                     bsk_base_log=out.bb1, ksk_level=out.kl1,
                     ksk_base_log=out.kb1, lwe_noise_std=out.lwe_noise_std,
                     glwe_noise_std=out.glwe1_noise_std)
    pr2 = TFHEParams(p=out.p2, lwe_dim=out.n, glwe_dim=out.k2,
                     poly_size=out.N2, bsk_level=out.bl2,
                     bsk_base_log=out.bb2, ksk_level=out.kl2,
                     ksk_base_log=out.kb2, lwe_noise_std=out.lwe_noise_std,
                     glwe_noise_std=out.glwe2_noise_std)
    return StagedSolution(pr1, pr2, out.cost_us, out.p_error)
