"""The plain reference against the port: its reading of both benchmark
programs (node order, wire rows, plaintext values), its decryption and
decoding, and a whole small run on the CPU judged correct."""

import numpy as np
import pytest
import torch

from bench_h100.harness.cell import is_correct, run_cell
from bench_h100.harness.spec import HERE
from bench_h100.reference import lwe
from bench_h100.reference.lbf import read_lbf

PROGRAMS = ["aes_128_4_search.lbf", "kreyvium_stream_v1_10_search.lbf"]


@pytest.fixture(scope="module", params=PROGRAMS)
def both(request):
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf

    text = (HERE / "programs" / request.param).read_text()
    return read_lbf(text), parse_lbf(text)


def test_node_order_and_rows_equal_the_ports(both):
    from tfhe_fbs_map_tpu_torch.runtime.executor import compile_program
    from tfhe_fbs_map_tpu_torch.tfhe.params import TEST_PARAMS

    ref, prog = both
    assert [n.kind for n in ref.nodes] == [n.kind for n in prog.nodes]
    for a, b in zip(ref.nodes, prog.nodes):
        if a.kind == "boot":
            assert a.table == b.table and a.src == b.src.nid
        elif a.kind == "lin":
            assert a.const == b.const
            assert a.terms == [(c, v.nid) for c, v in b.terms]
    plan = compile_program(prog, TEST_PARAMS.with_p(prog.fbs_size))
    rows = ref.rows()
    assert len(rows) + 1 == plan.num_wires
    for name, (kind, i) in ref.outputs.items():
        assert kind == "node"
        assert plan.outputs[name].wire_idx.tolist() == [rows[i]]


def test_plaintext_values_equal_the_ports(both):
    ref, prog = both
    rng = np.random.default_rng(5)
    inputs = {n.name: rng.integers(0, 2, 16) for n in ref.nodes
              if n.kind == "input"}
    vals = ref.evaluate(inputs)
    for name, want in prog.eval(inputs).items():
        assert np.array_equal(vals[ref.outputs[name][1]], want), name


@pytest.mark.parametrize("p", [4, 10])
def test_decryption_equals_the_ports(p):
    from tfhe_fbs_map_tpu_torch.tfhe.encrypt import (decode, encode,
                                                     lwe_encrypt, lwe_phase)
    from tfhe_fbs_map_tpu_torch.tfhe.params import TEST_PARAMS

    params = TEST_PARAMS.with_p(p)
    rng = np.random.default_rng(p)
    key = rng.integers(0, 2, 256).astype(np.int32)
    msgs = rng.integers(0, 2 * p, 500)
    cts = lwe_encrypt(torch.from_numpy(key), encode(msgs, params),
                      2.0 ** 20, rng)
    ph = lwe.phases(cts.numpy(), key)
    want = lwe_phase(torch.from_numpy(key), cts).numpy()
    assert np.array_equal(ph, want.astype(np.uint32).astype(np.int64))
    got, noise = lwe.decode(ph, p)
    assert np.array_equal(got, decode(want, params))
    assert np.array_equal(got, msgs % (2 * p))
    assert 0 < np.sqrt(np.mean(noise ** 2)) < 0.05
    assert lwe.delta(p) == params.delta


@pytest.mark.parametrize("kind", ["native", "staged"])
def test_small_run_is_correct(tiny, kind):
    run = run_cell(tiny(kind), 2 ** 33 + 7, 0.0, False, ["cpu"],
                   batches=2)
    assert run.attempted == 16 and run.failed == 0
    assert run.compared["wrong_bits"]["value"] == 0
    assert 0 < run.compared["noise_rms"]["value"] < 0.01
    assert is_correct(run)
