"""Build the CUDA kernels at first use and bind them with ctypes.

One ``nvcc`` per source under ``csrc/``, all started together, compiles it
to an object; one more links the objects into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) in
``build/tfhe_fbs_map_tpu_torch/`` beside the package.  The library's name
carries a hash of the sources and flags, so a changed source is rebuilt and
an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" \
    / "tfhe_fbs_map_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""            # nvcc's output of the last build (ptxas usage)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return found


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfbr_{h.hexdigest()[:16]}.so"


def compile_library(sources: list[Path], path: Path,
                    flags: tuple[str, ...] = ()) -> str:
    """Compile ``sources`` (one ``nvcc`` each, all started together, with
    ``csrc/`` on the include path and ``flags`` added) and link them into
    the shared library ``path``; returns nvcc's output."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-I", str(CSRC)]
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [subprocess.Popen([*cmd, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log = "".join(p.communicate()[0] for p in procs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        res = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        log += res.stdout + res.stderr
        failed = [res.returncode] if res.returncode != 0 else []
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, path)
    return log


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    global build_log
    path = library_path()
    if not path.exists():
        build_log = compile_library(sorted(CSRC.glob("*.cu")), path)
    return path


def bind(path: Path, parts: tuple[str, ...] = ("k1", "k2", "k1s")
         ) -> ctypes.CDLL:
    """Load the library at ``path`` and declare the C entries of the
    kernels in ``parts`` (a library built from some of the sources, as the
    bisect and the give-up test build them, has only theirs)."""
    lib = ctypes.CDLL(str(path))
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    entries = {}
    if "k1" in parts:  # K1's source also holds fbr_error_string
        entries.update({"fbr_error_string": [i],
                        "fbr_k1_blind_rotate": [p] * 6 + [i] * 11 + [p],
                        "fbr_k1_max_clusters": [i] * 5 + [ip],
                        "fbr_k1_layout": [i] * 3 + [ip, ip]})
    if "k2" in parts:
        entries.update({"fbr_k2_blind_rotate": [p] * 6 + [i] * 11 + [p],
                        "fbr_k2_max_clusters": [i] * 4 + [ip]})
    if "k1s" in parts:
        entries.update({"fbr_k1s_blind_rotate": [p] * 5 + [i] * 11 + [p],
                        "fbr_k1s_layout": [i] * 8 + [ip, ip]})
    for name, args in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = p if name == "fbr_error_string" else i
    return lib


def library() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib
