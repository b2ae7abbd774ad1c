"""The port's copy of the frontend against the JAX package's: the mapped
AES-128 ``.lbf`` parses to the same program, and the circuit parsers and the
mappers turn the same circuits into the same ``.lbf`` text."""

import io
from pathlib import Path

import numpy as np
import pytest

from tfhe_fbs_map_tpu import frontend as jf
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.frontend.parsers import parse_circuit as jparse
from tfhe_fbs_map_tpu_torch import frontend as tf
from tfhe_fbs_map_tpu_torch.frontend.parsers import parse_circuit as tparse
from tfhe_fbs_map_tpu_torch.runtime import executor as texec
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS

ROOT = Path(__file__).resolve().parents[1]
AES_LBF = ROOT / "outputs" / "bristol" / "aes_128_4_search.lbf"


def lbf_text(prog) -> str:
    out = io.StringIO()
    prog.write_lbf(out)
    return out.getvalue()


def ripple_adder(bits: int):
    """A ``bits``-bit ripple-carry adder built with the JAX BitCircuit."""
    c = jf.BitCircuit()
    xs = [c.add_input(f"x{i}") for i in range(bits)]
    ys = [c.add_input(f"y{i}") for i in range(bits)]
    carry = c.add_input("cin")
    for i, (x, y) in enumerate(zip(xs, ys)):
        p = c.xor_(x, y)
        c.set_output(f"s{i}", c.xor_(p, carry))
        carry = c.or_(c.and_(x, y), c.and_(p, carry))
    c.set_output("cout", carry)
    return c


CIRCUITS = {"full_adder": lambda: build_bench("full_adder"),
            "aes_sbox": lambda: build_bench("aes_sbox"),
            "ripple_adder_8": lambda: ripple_adder(8)}


def test_public_names_equal():
    # the port also exports the optimizer (``frontend.opt``) at the top
    assert sorted(tf.__all__) == sorted(jf.__all__ + ["optimize"])


def test_aes128_lbf_parses_to_the_same_program():
    text = AES_LBF.read_text()
    want, got = jf.parse_lbf(text), tf.parse_lbf(text)
    assert got.stats() == want.stats()
    assert lbf_text(got) == lbf_text(want)
    rng = np.random.default_rng(3)
    names = [n.name for n in want.nodes if n.kind == "input"]
    values = {n: rng.integers(0, 2, 16) for n in names}
    ev_want, ev_got = want.eval(values), got.eval(values)
    assert sorted(ev_got) == sorted(ev_want)
    for k in ev_want:
        assert np.array_equal(np.asarray(ev_got[k]), np.asarray(ev_want[k]))
    # the executor's plan arrays, compiled from each copy's program
    params = PRESETS["aes128_p4"][0]
    a, b = texec.compile_program(want, params), \
        texec.compile_program(got, params)
    assert len(a.levels) == len(b.levels) == 230
    for la, lb in zip(a.levels, b.levels):
        for f in ("wire_idx", "coefs", "consts", "test_polys", "posts",
                  "out_rows"):
            assert np.array_equal(getattr(la, f), getattr(lb, f)), f


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("mapper", ["basic", "search", "best"])
def test_parse_and_map_give_the_same_lbf(name, mapper, tmp_path):
    blif = tmp_path / f"{name}.blif"
    with open(blif, "w") as f:
        CIRCUITS[name]().to_blif(f, model_name=name)
    jc, tc = jparse(str(blif), "blif"), tparse(str(blif), "blif")
    assert tc.stats() == jc.stats()
    rng = np.random.default_rng(5)
    values = {n.name: rng.integers(0, 2, 32) for n in jc.nodes
              if n.kind == "input"}
    progs = []
    for mod, circ in ((jf, jc), (tf, tc)):
        if mapper == "basic":
            prog = mod.BasicMapper().map(circ)
        elif mapper == "best":
            prog = mod.map_best(circ, fbs_size=4)
        else:
            prog = mod.HeuristicMapper(cone_merger="search",
                                       fbs_size=4).map(circ)
        prog.remove_dangling_nodes()
        progs.append(prog)
    want, got = progs
    assert lbf_text(got) == lbf_text(want)
    assert got.stats() == want.stats()
    ev = got.eval(values)
    for k, v in tc.eval(values).items():
        assert np.array_equal(np.asarray(ev[k]), np.asarray(v))
