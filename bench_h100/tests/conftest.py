"""Shared pieces of the harness's tests: the checkout on ``sys.path`` and
two small cells built on the CPU from the port's mapper, one native at the
test parameters and one staged at p=10 over two tiny families.

    python -m pytest bench_h100/tests -q
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# tests share the cores: one torch thread each
torch.set_num_threads(1)

TINY_STAGED_FAMILIES = [
    dict(p=10, lwe_dim=16, glwe_dim=1, poly_size=256, bsk_level=3,
         bsk_base_log=7, ksk_level=4, ksk_base_log=4, lwe_noise_std=2.0,
         glwe_noise_std=2.0),
    dict(p=5, lwe_dim=16, glwe_dim=2, poly_size=128, bsk_level=3,
         bsk_base_log=7, ksk_level=4, ksk_base_log=4, lwe_noise_std=2.0,
         glwe_noise_std=2.0),
]


def _write(prog, path: Path) -> str:
    with open(path, "w") as f:
        prog.write_lbf(f)
    return str(path)


@pytest.fixture(scope="session")
def programs(tmp_path_factory):
    """Paths of a full adder mapped at p=4 and one Kreyvium round mapped
    at p=10 (``.lbf``)."""
    from tfhe_fbs_map_tpu_torch.frontend.circuits.generators import \
        BENCH_GENERATORS
    from tfhe_fbs_map_tpu_torch.frontend.mapping.heuristic import \
        HeuristicMapper
    from tfhe_fbs_map_tpu_torch.frontend.parsers import parse_circuit

    d = tmp_path_factory.mktemp("programs")
    fa = HeuristicMapper(cone_merger="search", fbs_size=4).map(
        parse_circuit(str(ROOT / "benchmarks/bristol/full_adder.txt"),
                      "bristol"))
    fa.remove_dangling_nodes()
    kr = HeuristicMapper(cone_merger="search", fbs_size=10).map(
        BENCH_GENERATORS["kreyvium_iter_v1"]())
    kr.remove_dangling_nodes()
    return {"native": _write(fa, d / "full_adder_4.lbf"),
            "staged": _write(kr, d / "kreyvium_iter_10.lbf")}


def tiny_cell(programs, kind: str, batch: int = 8, orientation="auto",
              noise_limit: float = 0.01):
    """A :class:`..harness.spec.Cell` of a small program on the CPU."""
    from bench_h100.harness.spec import Cell
    from tfhe_fbs_map_tpu_torch.tfhe.params import TEST_PARAMS

    if kind == "native":
        cfg = {"p": 4, "staged": False,
               "families": [dataclasses.asdict(TEST_PARAMS)]}
    else:
        cfg = {"p": 10, "staged": True, "families": TINY_STAGED_FAMILIES}
    cfg.update(name=f"tiny_{kind}", program=programs[kind], bsk_limbs=4,
               orientation=orientation,
               limits={"wrong_bits": 0, "noise_rms": noise_limit})
    return Cell(f"tiny_{kind}.b{batch}", 1, cfg,
                {"name": f"b{batch}", "batch": batch, "dp": 1})


@pytest.fixture
def tiny(programs):
    """``tiny(kind, batch=8, orientation="auto", noise_limit=0.01)``: a
    small cell (:func:`tiny_cell`)."""
    def make(kind, **kw):
        return tiny_cell(programs, kind, **kw)
    return make
