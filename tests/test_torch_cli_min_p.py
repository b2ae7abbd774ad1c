"""A ``basic``-mapped program is labelled p=2, while its 2-input gates'
tables need p=3: the runtime CLIs run it at the p they take from the
``.lbf``.

The JAX CLI takes the label (``tfhe_fbs_map_tpu/runtime/cli.py:130``): the
optimizer is asked for p=2 and the run fails in ``build_test_vector``.  The
port's CLI takes ``max(label, min_fbs_size())``, the p the port's sweep
prices such a row at (``harness/sweep.py``), and runs it bit-exact at p=3.
Both CLIs run in this process, on the CPU, with their optimizers
monkeypatched to the test family at the p they are asked for (the real
picks are far too large for a CPU run); ISCAS85 c17 is mapped by the port's
mapping CLI, whose bytes equal the JAX CLI's (``test_torch_frontend_cli``).
"""

import json
from pathlib import Path

import pytest
import torch

import tfhe_fbs_map_tpu.optimizer as jopt
from tfhe_fbs_map_tpu.optimizer.optimizer import Solution as JSolution
from tfhe_fbs_map_tpu.runtime import cli as jcli
from tfhe_fbs_map_tpu.tfhe.params import TEST_PARAMS as JTEST
import tfhe_fbs_map_tpu_torch.optimizer as topt
from tfhe_fbs_map_tpu_torch.frontend import cli as fcli
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.optimizer.optimizer import Solution
from tfhe_fbs_map_tpu_torch.runtime import cli as tcli
from tfhe_fbs_map_tpu_torch.tfhe.params import TEST_PARAMS

ROOT = Path(__file__).resolve().parents[1]

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture()
def c17_basic(tmp_path, capsys):
    """ISCAS85 c17 mapped by the basic mapper at the sweep's p=2 baseline."""
    lbf = tmp_path / "c17_basic.lbf"
    assert fcli.main([str(ROOT / "benchmarks" / "iscas85" / "c17.bench"),
                      "--type", "bench", "--mapper", "basic", "--fbs_size",
                      "2", "--output_lbf", str(lbf)]) == 0
    capsys.readouterr()
    prog = parse_lbf(lbf.read_text())
    assert (prog.fbs_size, prog.min_fbs_size()) == (2, 3)
    return str(lbf)


def test_jax_cli_runs_the_label_and_fails(c17_basic, monkeypatch):
    asked = []

    def optimize(p, sq_norm2, **kw):
        asked.append(p)
        return JSolution(JTEST.with_p(p), 1.0, 1e-9)
    monkeypatch.setattr(jopt, "optimize", optimize)
    with pytest.raises(AssertionError, match="negacyclic"):
        jcli.main([c17_basic, "--batch", "4"])
    assert asked == [2]


@pytest.mark.parametrize("extra", [[], ["--fbs_size", "3"]])
def test_port_cli_runs_the_least_p_bit_exact(c17_basic, monkeypatch, capsys,
                                             extra):
    """Without ``--fbs_size`` the port runs what ``--fbs_size 3`` runs."""
    asked = []

    def optimize(p, sq_norm2, **kw):
        asked.append(p)
        return Solution(TEST_PARAMS.with_p(p), 1.0, 1e-9, 4)
    monkeypatch.setattr(topt, "optimize", optimize)
    rc = tcli.main([c17_basic, "--batch", "4", "--device", "cpu", *extra])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["bit_exact"] and res["params_from"] == "optimizer"
    assert asked == [3] and res["params"]["p"] == 3
