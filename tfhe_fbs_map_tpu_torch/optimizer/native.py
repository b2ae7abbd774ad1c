"""ctypes binding of the port's native (C++) optimizer core.

``optimizer/csrc/optimizer.cpp`` is the C++ counterpart of
:mod:`.optimizer`, as ``native/optimizer.cpp`` is the JAX package's: the
same grids, order and pruning, and the serving rules of the CUDA kernels.
It takes the :class:`DeviceProfile` as an argument, so one build prices any
card.  It is built with ``g++`` at first use into the git-ignored
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
from ..ops.fused_blind_rotate import K1_MAX_N, K1_SLICE, K2_CHUNK, K2_KC
from ..tfhe.params import TFHEParams
from .noise import P_ERROR_4_SIGMA
from .optimizer import DeviceProfile, Solution, StagedSolution, h100_profile

__all__ = ["native_available", "native_model_fns", "optimize_native",
           "optimize_staged_native", "profile_struct"]

SRC = Path(__file__).resolve().parent / "csrc" / "optimizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "tfhe_fbs_map_tpu_torch"
# -ffp-contract=off: a fused multiply-add would round once where Python
# rounds twice, and the floats must be the Python search's bits
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]

_lib = None

i32, f64 = ctypes.c_int32, ctypes.c_double


class _CProfile(ctypes.Structure):
    _fields_ = [
        ("int8_ops", f64), ("mem_bytes", f64), ("eff_fused", f64),
        ("eff_otf", f64), ("k2_memory", f64), ("k2_headroom", f64),
        ("cuda_kernels", i32), ("k1_slice", i32), ("k1_max_n", i32),
        ("k2_kc", i32), ("k2_chunk", i32), ("ksk_max_base_log", i32),
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
# nv_serves an int)
_MODEL_FNS = {
    "nv_var_blind_rotate": [i32, i32, i32, i32, i32, f64],
    "nv_var_keyswitch": [i32, i32, i32, i32, f64],
    "nv_var_modswitch": [i32, i32],
    "nv_var_bsk_quantization": [i32, i32, i32, i32, i32, i32],
    "nv_p_error_atomic": [i32, f64, i32, i32, i32, i32, i32, i32, i32, f64,
                          f64, i32],
    "nv_p_error_from_var": [i32, f64],
    "nv_bootstrap_cost_us": [i32, i32, i32, i32, i32, i32, i32, _PROFILE],
    "nv_serves": [i32, i32, i32, i32, i32, i32, i32, i32, _PROFILE],
}


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
        fn.restype = i32 if name == "nv_serves" else f64
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


def profile_struct(profile: DeviceProfile) -> _CProfile:
    """``profile`` and the CUDA kernels' serving limits as the C struct."""
    return _CProfile(
        profile.int8_ops, profile.mem_bytes, profile.eff_fused,
        profile.eff_otf, profile.k2_memory, profile.k2_headroom,
        int(profile.cuda_kernels), K1_SLICE, K1_MAX_N, K2_KC, K2_CHUNK,
        KSK_MAX_BASE_LOG)


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
