"""The port's logic optimizer (``frontend/opt.py``) and mapping CLI
(``frontend/cli.py``) against the JAX package's: the same circuits node for
node, the same stats line and exit codes, byte-equal ``.fbs`` and ``.lbf``
files.  Every value is compared with ``==``."""

import ast
import contextlib
import io
from pathlib import Path

import numpy as np
import pytest

from tfhe_fbs_map_tpu.frontend import bit_circuit as jbc
from tfhe_fbs_map_tpu.frontend import cli as jcli
from tfhe_fbs_map_tpu.frontend import opt as jopt
from tfhe_fbs_map_tpu.frontend.parsers import parse_circuit as jparse
from tfhe_fbs_map_tpu_torch.frontend import bit_circuit as tbc
from tfhe_fbs_map_tpu_torch.frontend import cli as tcli
from tfhe_fbs_map_tpu_torch.frontend import opt as topt
from tfhe_fbs_map_tpu_torch.frontend.parsers import parse_circuit as tparse

ROOT = Path(__file__).resolve().parents[1]
I85 = "benchmarks/iscas85"


def describe(circ):
    """Everything the mapper downstream reads, in node order."""
    return ([(n.nid, n.name, n.kind, tuple(f.name for f in n.fanins),
              n.table) for n in circ.nodes],
            [n.name for n in circ.inputs],
            [(k, v.name) for k, v in circ.outputs.items()])


# (file, parser type, parser keywords)
CIRCUITS = {
    "c17": (f"{I85}/c17.bench", "bench", {}),
    "c432r": (f"{I85}/c432r.bench", "bench", {}),
    "c6288r": (f"{I85}/c6288r.bench", "bench", {}),
    "s27 x4": ("benchmarks/iscas89/s27.bench", "bench",
               {"unroll_frames": 4}),
    "trivium_iter_v2": ("benchmarks/generated/trivium_iter_v2.blif", "blif",
                        {}),
}


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_optimize_gives_the_same_circuit(name):
    path, kind, kw = CIRCUITS[name]
    want = jopt.optimize(jparse(str(ROOT / path), kind, **kw))
    got = topt.optimize(tparse(str(ROOT / path), kind, **kw))
    assert describe(got) == describe(want)
    assert got.stats() == want.stats()


def random_dag_specs(cases: int = 40, seed: int = 1234) -> list:
    """The random 2-input-LUT DAGs of ``tests/test_opt.py``'s
    ``test_random_dags_equiv``, drawn in its order, as (inputs, gates as
    (pool indices, table), output pool indices); pool = inputs, CONST0,
    CONST1, then the gates."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(cases):
        n_in = int(rng.integers(2, 6))
        size = n_in + 2
        gates = []
        for _ in range(int(rng.integers(1, 40))):
            k = int(rng.integers(1, 3))
            fanins = [int(rng.integers(0, size)) for _ in range(k)]
            while k == 2 and fanins[0] == fanins[1]:
                fanins[1] = int(rng.integers(0, size))
            t = rng.integers(0, 2, 1 << k)
            if t.min() == t.max():
                t[0] = 1 - t[0]
            gates.append((fanins, tuple(int(v) for v in t)))
            size += 1
        outs = [int(rng.integers(0, size))
                for _ in range(int(rng.integers(1, 4)))]
        specs.append((n_in, gates, outs))
    return specs


SPECS = random_dag_specs()


def build(mod, spec):
    n_in, gates, outs = spec
    c = mod.BitCircuit()
    pool = [c.add_input(f"i{k}") for k in range(n_in)]
    pool += [mod.CONST0, mod.CONST1]
    for fanins, table in gates:
        pool.append(c.lut([pool[i] for i in fanins], table))
    for o, i in enumerate(outs):
        c.set_output(f"o{o}", pool[i])
    return c


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_optimize_random_dags(case):
    want = jopt.optimize(build(jbc, SPECS[case]))
    got = topt.optimize(build(tbc, SPECS[case]))
    assert describe(got) == describe(want)
    # and the port's result computes the source's function
    src = build(tbc, SPECS[case])
    rng = np.random.default_rng(case)
    vals = {n.name: rng.integers(0, 2, 64) for n in src.inputs}
    ev_src, ev_got = src.eval(vals), got.eval(vals)
    # a constant output evaluates to a scalar
    ones = np.ones(64, dtype=np.int64)
    assert ev_src.keys() == ev_got.keys()
    assert all(np.array_equal(np.asarray(ev_src[k]) * ones,
                              np.asarray(ev_got[k]) * ones) for k in ev_src)


def run_cli(main, argv: list) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


CLI_CASES = {
    "c17 p3 opt": [f"{I85}/c17.bench", "--type", "bench", "--fbs_size", "3",
                   "--opt"],
    "c432r p4 opt": [f"{I85}/c432r.bench", "--type", "bench", "--fbs_size",
                     "4", "--opt"],
    "c3540r p10 search+dc opt": [f"{I85}/c3540r.bench", "--type", "bench",
                                 "--fbs_size", "10", "--mapper", "search+dc",
                                 "--opt"],
    "s27 x4 p4": ["benchmarks/iscas89/s27.bench", "--type", "bench",
                  "--unroll_frames", "4", "--fbs_size", "4"],
    "aes_sbox blif p4": ["benchmarks/generated/aes_sbox.blif", "--fbs_size",
                         "4"],
}


@pytest.mark.parametrize("name", sorted(CLI_CASES))
def test_cli_writes_the_same_bytes(name, tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    fbs, lbf = tmp_path / "out.fbs", tmp_path / "out.lbf"
    argv = CLI_CASES[name] + ["--output", str(fbs), "--output_lbf", str(lbf)]
    runs = []
    for main in (jcli.main, tcli.main):
        rc, lines = run_cli(main, argv)
        stats = ast.literal_eval(lines[-1])
        runs.append((rc, stats, fbs.read_bytes(), lbf.read_bytes()))
        fbs.unlink()
        lbf.unlink()
    (rc_j, stats_j, fbs_j, lbf_j), (rc_t, stats_t, fbs_t, lbf_t) = runs
    assert rc_j == rc_t == 0
    assert stats_j.pop("time") >= 0 and stats_t.pop("time") >= 0
    assert stats_t == stats_j
    assert stats_t["nb_bootstrap"] > 0
    assert fbs_t == fbs_j and lbf_t == lbf_j


def test_cli_maps_c6288r_to_944_bootstraps(tmp_path, monkeypatch):
    """The 16×16 multiplier as ``chip_smoke.py`` phase 8 maps it."""
    monkeypatch.chdir(ROOT)
    lbf = tmp_path / "c6288r.lbf"
    rc, lines = run_cli(tcli.main, [f"{I85}/c6288r.bench", "--type", "bench",
                                    "--fbs_size", "4", "--opt",
                                    "--output_lbf", str(lbf)])
    stats = ast.literal_eval(lines[-1])
    assert rc == 0 and stats["nb_bootstrap"] == 944 and lbf.stat().st_size


def test_cli_missing_file_exits_2(tmp_path):
    argv = [str(tmp_path / "missing.bench"), "--type", "bench"]
    assert run_cli(jcli.main, argv)[0] == run_cli(tcli.main, argv)[0] == 2


def test_cli_mapping_exception_exits_0(tmp_path, monkeypatch):
    """The naive merger at FBS size 2 cannot map an AND gate: both CLIs log
    the exception, print no stats and exit 0, so a sweep goes on."""
    monkeypatch.chdir(ROOT)
    argv = ["benchmarks/generated/full_adder.blif", "--fbs_size", "2",
            "--mapper", "naive", "--strict_fbs_size"]
    assert run_cli(jcli.main, argv) == run_cli(tcli.main, argv) == (0, [])
