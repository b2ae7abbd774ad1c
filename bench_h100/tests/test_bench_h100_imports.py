"""No module the benchmark runs imports JAX or the JAX package, compared
by whole top-level names (``tfhe_fbs_map_tpu_torch`` begins with
``tfhe_fbs_map_tpu``); the reference imports nothing of the port either,
only NumPy and the standard library."""

import ast
import subprocess
import sys

from bench_h100.harness.spec import HERE, ROOT

FOREIGN = {"jax", "jaxlib", "flax", "tfhe_fbs_map_tpu"}


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        found = set(imports(path)) & FOREIGN
        assert not found, (path, found)


def test_reference_imports_numpy_alone():
    for path in (HERE / "reference").rglob("*.py"):
        tops = set(imports(path))
        assert tops <= {"numpy", "dataclasses", "__future__"}, (path, tops)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'bench_h100'); import run; "
            "import bench_h100.harness.cell, bench_h100.control; "
            "from bench_h100.harness.cell import run_cell; "
            "import tfhe_fbs_map_tpu_torch.runtime.cli, "
            "tfhe_fbs_map_tpu_torch.runtime.executor, "
            "tfhe_fbs_map_tpu_torch.ops.blind_rotate, "
            "tfhe_fbs_map_tpu_torch.tfhe.staged; "
            "print(run.foreign_modules())")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
