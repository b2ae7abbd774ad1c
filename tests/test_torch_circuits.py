"""The port's benchmark generators write the JAX package's bytes.

Every generated-suite and EPFL generator, the ISCAS85/89 "r" regenerations
(against the JAX module and the committed ``benchmarks/`` files), the
AES-128 Bristol netlist, and the command line's output directory, each
compared byte for byte with the JAX package's ``frontend.circuits``."""

import io
import subprocess
import sys
from pathlib import Path

import pytest

import tfhe_fbs_map_tpu.frontend.circuits as J
import tfhe_fbs_map_tpu.frontend.circuits.aes128 as jaes
import tfhe_fbs_map_tpu.frontend.circuits.bench_regen as jregen
import tfhe_fbs_map_tpu_torch.frontend.circuits as T
import tfhe_fbs_map_tpu_torch.frontend.circuits.aes128 as taes
import tfhe_fbs_map_tpu_torch.frontend.circuits.bench_regen as tregen

ROOT = Path(__file__).resolve().parents[1]


def blif(circ, name: str) -> str:
    buf = io.StringIO()
    circ.to_blif(fs=buf, model_name=name)
    return buf.getvalue()


@pytest.mark.parametrize("name", list(J.BENCH_GENERATORS))
def test_bench_generator_writes_jax_bytes(name):
    assert list(T.BENCH_GENERATORS) == list(J.BENCH_GENERATORS)
    got = blif(T.build_bench(name), name)
    assert got == blif(J.build_bench(name), name)
    assert got.startswith(".model")


@pytest.mark.parametrize("name", list(J.EPFL_GENERATORS))
def test_epfl_generator_writes_jax_bytes(name):
    """As the sweeps write them: dangling nodes removed first."""
    assert list(T.EPFL_GENERATORS) == list(J.EPFL_GENERATORS)
    got, want = T.EPFL_GENERATORS[name](), J.EPFL_GENERATORS[name]()
    got.remove_dangling_nodes()
    want.remove_dangling_nodes()
    assert blif(got, name) == blif(want, name)


@pytest.fixture(scope="module")
def regenerated(tmp_path_factory):
    """``emit_all`` of both packages, each into its own directory."""
    t, j = tmp_path_factory.mktemp("torch"), tmp_path_factory.mktemp("jax")
    for d in ("iscas85", "iscas89"):
        (j / d).mkdir()
    return ([Path(p) for p in tregen.emit_all(str(t))],
            [Path(p) for p in jregen.emit_all(str(j))])


REGEN = [("iscas85", n) for n in jregen.REGEN85] + \
    [("iscas89", n) for n in jregen.REGEN89]


@pytest.mark.parametrize("suite,name", REGEN)
def test_bench_regen_writes_jax_and_committed_bytes(regenerated, suite,
                                                    name):
    ours, theirs = regenerated
    assert [p.relative_to(p.parents[1]) for p in ours] == \
        [p.relative_to(p.parents[1]) for p in theirs]
    got = next(p for p in ours if p.parts[-2:] == (suite, f"{name}.bench"))
    want = next(p for p in theirs
                if p.parts[-2:] == (suite, f"{name}.bench"))
    committed = ROOT / "benchmarks" / suite / f"{name}.bench"
    assert got.read_bytes() == want.read_bytes() == committed.read_bytes()


def test_aes128_netlist_equals_jax_and_committed():
    text = taes.emit_aes128()
    assert text == jaes.emit_aes128()
    assert text == (ROOT / "benchmarks" / "bristol" / "aes_128.txt") \
        .read_text()


def test_command_line_writes_jax_bytes(tmp_path):
    names = ["full_adder", "ascon_lut", "aes_sbox"]
    for pkg, flag, out in (("tfhe_fbs_map_tpu_torch", "--out", "t"),
                           ("tfhe_fbs_map_tpu", "--prefix", "j")):
        res = subprocess.run(
            [sys.executable, "-m", f"{pkg}.frontend.circuits", flag,
             str(tmp_path / out), "--bench", *names],
            cwd=ROOT, capture_output=True, text=True)
        assert res.returncode == 0, res.stderr
    for name in names:
        got = (tmp_path / "t" / f"{name}.blif").read_bytes()
        assert got == (tmp_path / "j" / f"{name}.blif").read_bytes()


def test_command_line_needs_an_output_directory():
    res = subprocess.run(
        [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.frontend.circuits"],
        cwd=ROOT, capture_output=True, text=True)
    assert res.returncode != 0 and "--out" in res.stderr
