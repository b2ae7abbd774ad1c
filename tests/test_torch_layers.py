"""The port's layers form a chain, from the executor through the cost model
to the kernels: no module of the kernel layer (``ops/``) imports from the
cost model (``optimizer/``), so the kernel layer runs the launch it is
handed (``runtime_model.launch_choice``) and prices nothing.  An AST scan
of the sources, imports inside functions included."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "tfhe_fbs_map_tpu_torch"
OPS = sorted(p.name for p in (PKG / "ops").glob("*.py"))


def imported(path: Path) -> set[str]:
    """Every module ``path`` imports, as an absolute dotted name."""
    package = "tfhe_fbs_map_tpu_torch." + path.parent.name
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            names.add(mod)
            names |= {f"{mod}.{a.name}" for a in node.names}
    return names


def test_the_scan_sees_relative_and_late_imports(tmp_path):
    (tmp_path / "ops").mkdir()
    src = tmp_path / "ops" / "m.py"
    src.write_text("from . import _build\n"
                   "def f():\n"
                   "    from ..optimizer import runtime_model\n"
                   "    from ..optimizer.runtime_model import kernel_us\n")
    got = imported(src)
    assert "tfhe_fbs_map_tpu_torch.ops._build" in got
    assert "tfhe_fbs_map_tpu_torch.optimizer.runtime_model" in got
    assert "tfhe_fbs_map_tpu_torch.optimizer.runtime_model.kernel_us" in got


@pytest.mark.parametrize("name", OPS)
def test_kernel_layer_imports_no_cost_model(name):
    assert OPS and "fused_blind_rotate.py" in OPS
    up = sorted(m for m in imported(PKG / "ops" / name)
                if m.startswith("tfhe_fbs_map_tpu_torch.optimizer"))
    assert not up, f"ops/{name} imports {up}"
