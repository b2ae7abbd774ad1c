"""CUDA kernels of the PyTorch port against their plain versions (needs a
GPU; skips without one).  This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import json

import numpy as np
import pytest
import torch

from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
    functional_bootstrap_fast, prepare_fast_keys)
from tfhe_fbs_map_tpu_torch.tfhe import (TEST_PARAMS, build_test_vector,
                                         encrypt_values,
                                         functional_bootstrap, generate_keys)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def operands(params, batch, otf, seed):
    rng = np.random.default_rng(seed)
    k1, N = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level
    b_init = rng.integers(0, 2 * N, (batch, 1)).astype(np.int32)
    a_t = rng.integers(0, 2 * N, (params.lwe_dim, batch, 1)).astype(np.int32)
    a_t[:, :4, 0] = [0, N - 1, N, 2 * N - 1][:batch]
    tvs = rng.integers(-2 ** 31, 2 ** 31, (batch, N)).astype(np.int32)
    shape = ((params.lwe_dim, 4 * k1, rows, 2 * N) if otf
             else (params.lwe_dim, 4 * k1 * N, rows * N))
    keys = rng.integers(-128, 128, shape, dtype=np.int8)
    return [torch.from_numpy(x) for x in (b_init, a_t, tvs, keys)]


# K1 over its batch tiles; K2 at each plan k2_plan picks (132 SMs) for the
# main path's batch sizes, forced where the card has another SM count
K2_PLANS = sorted({(b, p.cb, p.cluster) for b in (1, 21, 64, 512, 1024)
                   for p in [fbr.k2_plan(b, TEST_PARAMS, 132)]})


@pytest.mark.parametrize("otf,batch,plan",
                         [(True, 21, None)]
                         + [(False, b, (cb, c)) for b, cb, c in K2_PLANS])
def test_kernel_equals_plain_every_tile(cuda, otf, batch, plan):
    args = operands(TEST_PARAMS, batch, otf, seed=1)
    dev = [x.to(cuda) for x in args]
    key = "k1" if otf else "k2"
    if otf:
        plain = fbr.blind_rotate_fused(*args, TEST_PARAMS)
        runs = [dict(batch_tile=t) for t in (None,) + fbr.TILES]
    else:
        plain = fbr.blind_rotate_k2_plain(*dev, TEST_PARAMS).cpu()
        runs = [dict(batch_tile=plan[0], cluster=plan[1])]
    for kw in runs:
        before = fbr.LAUNCHES[key]
        fn = fbr.blind_rotate_k1 if otf else fbr.blind_rotate_k2
        got = fn(*dev, TEST_PARAMS, **kw)
        torch.cuda.synchronize()
        assert fbr.LAUNCHES[key] == before + 1
        assert torch.equal(got.cpu(), plain), kw


@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_fast_bootstrap_on_cuda_equals_generic_on_cpu(cuda, orientation):
    keys_gpu = generate_keys(TEST_PARAMS, seed=4, device=cuda)
    keys_cpu = generate_keys(TEST_PARAMS, seed=4, device="cpu")
    assert torch.equal(keys_gpu.bsk.cpu(), keys_cpu.bsk)
    assert torch.equal(keys_gpu.ksk.cpu(), keys_cpu.ksk)
    table = [0, 1, 1, 0, 1]
    values = np.random.default_rng(5).integers(0, len(table), 40)
    cts = encrypt_values(keys_cpu, values, np.random.default_rng(6))
    tv, post = build_test_vector(table, TEST_PARAMS)
    tvs = torch.from_numpy(np.tile(tv, (len(values), 1)))
    posts = torch.full((len(values),), post, dtype=torch.int32)
    want = functional_bootstrap(keys_cpu, cts, tvs, posts)
    fast = prepare_fast_keys(keys_gpu, orientation=orientation)
    got = functional_bootstrap_fast(fast, cts.to(cuda), tvs.to(cuda),
                                    posts.to(cuda))
    assert torch.equal(got.cpu(), want)


def test_cli_on_cuda(cuda, tmp_path, capsys):
    from tfhe_fbs_map_tpu.frontend.circuits import build_bench
    from tfhe_fbs_map_tpu_torch.runtime.cli import main
    blif = tmp_path / "fa.blif"
    with open(blif, "w") as f:
        build_bench("full_adder").to_blif(f, model_name="fa")
    for orientation, key in (("fused", "k2"), ("fused_otf", "k1")):
        before = fbr.LAUNCHES[key]
        rc = main([str(blif), "--map", "--batch", "4", "--test-params",
                   "--orientation", orientation])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["bit_exact"]
        assert fbr.LAUNCHES[key] > before
