"""The PyTorch port imports neither JAX nor the JAX package: every module
imports with both blocked, and neither the package nor ``chip_smoke.py``
names them."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import tfhe_fbs_map_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tfhe_fbs_map_tpu_torch"
JAX_IMPORT = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
# any module of the JAX package, its framework-free frontend included
JAX_PACKAGE = re.compile(
    r"^\s*(from|import)\s+tfhe_fbs_map_tpu(?!_torch)\b", re.M)


def modules():
    names = ["tfhe_fbs_map_tpu_torch"]
    for info in pkgutil.walk_packages(tfhe_fbs_map_tpu_torch.__path__,
                                      "tfhe_fbs_map_tpu_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_every_module_imports_with_jax_blocked():
    names = modules()
    assert "tfhe_fbs_map_tpu_torch.ops.fused_blind_rotate" in names
    assert "tfhe_fbs_map_tpu_torch.frontend.mapping.heuristic" in names
    for name in ("frontend.opt", "frontend.cli", "utils.profiling", "bench",
                 "bench_multichip", "parallel", "parallel.mesh",
                 "parallel.distributed", "parallel.dryrun",
                 "frontend.circuits", "frontend.circuits.dsl",
                 "frontend.circuits.generators",
                 "frontend.circuits.epfl_control",
                 "frontend.circuits.bench_regen",
                 "frontend.circuits.aes128", "optimizer.native", "harness",
                 "harness.sweep", "harness.reestimate_staged",
                 "harness.analyse"):
        assert f"tfhe_fbs_map_tpu_torch.{name}" in names
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfhe_fbs_map_tpu'] = None\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [k for k, v in sys.modules.items() if v]\n"
            "assert not [k for k in loaded if k == 'jax'\n"
            "            or k.split('.')[0] == 'tfhe_fbs_map_tpu'], loaded\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert PKG / "frontend" / "circuits" / "__main__.py" in files
    for f in files:
        text = f.read_text()
        assert not JAX_IMPORT.search(text), f
        assert not JAX_PACKAGE.search(text), f


def test_chip_smoke_alone_fails(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
