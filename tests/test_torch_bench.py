"""The port's bench (``python -m tfhe_fbs_map_tpu_torch.bench``): the native
XOR chain bitwise against the JAX package's generic bootstrap chain at the
``--quick`` set, the command line on the CPU, and the kernel each preset
takes.  Every value is compared with ``==``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
from tfhe_fbs_map_tpu_torch import bench
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.tfhe.keys import generate_keys
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# bench.py:181-196, the JAX bench's JSON keys
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "params",
            "device", "keygen_s", "compile_s", "ms_per_bootstrap", "errors"}
# an H100 80GB HBM3's free memory (torch.cuda.mem_get_info), MiB
H100_FREE_MIB = 81_559


def test_quick_set_is_the_jax_bench_one():
    assert vars(bench.QUICK_PARAMS) == vars(J.TFHEParams(
        p=4, lwe_dim=32, glwe_dim=1, poly_size=128, bsk_level=2,
        bsk_base_log=7, ksk_level=3, ksk_base_log=4, lwe_noise_std=4.0,
        glwe_noise_std=4.0))


def jax_chain(batch: int):
    """bench.py:134-165 with the generic bootstrap: seed-1 keys, seed-2
    values and ciphertexts; yields the ciphertexts after every step."""
    params = J.TFHEParams(**vars(bench.QUICK_PARAMS))
    keys = J.generate_keys(params, seed=1)
    rng = np.random.default_rng(2)
    values = rng.integers(0, 3, batch)
    cts = J.encrypt_values(keys, values, rng)
    tv, post = J.build_test_vector([1, 0, 1], params)
    tvs = jnp.broadcast_to(jnp.asarray(tv), (batch, params.poly_size))
    posts = jnp.full((batch,), np.int32(post))
    while True:
        cts = J.functional_bootstrap(keys, cts, tvs, posts)
        yield np.asarray(cts)


def test_conv_anchor_is_the_jax_bench_one():
    """bench.py:104-111, the set the JAX bench takes for a conv
    orientation."""
    assert vars(bench.CONV_ANCHOR) == vars(J.TFHEParams(
        p=4, lwe_dim=630, glwe_dim=2, poly_size=512, bsk_level=3,
        bsk_base_log=7, ksk_level=5, ksk_base_log=3,
        lwe_noise_std=2.0 ** (32 - 15.0), glwe_noise_std=2.0 ** (32 - 25.0)))


@pytest.mark.parametrize("orientation", ["fused", "fused_otf", "keys_rhs",
                                         "keys_lhs", "keys_lhs_bf16"])
def test_xor_chain_equals_the_jax_generic_chain(orientation):
    """The chain after its first step and after two timed steps is bitwise
    the JAX generic chain's, through either kernel's plain version and
    through each conv orientation."""
    batch = bench.QUICK_BATCH["native"]
    keys = generate_keys(bench.QUICK_PARAMS, seed=1, device="cpu")
    chain = bench.XorChain(keys, prepare_fast_keys(keys, orientation), batch)
    want = jax_chain(batch)
    chain.step()
    assert np.array_equal(chain.cts.numpy(), next(want))
    assert chain.wrong(1) == 0
    chain.step()
    chain.step()
    next(want)
    assert np.array_equal(chain.cts.numpy(), next(want))
    assert chain.wrong(3) == 0 and chain.wrong(2) == batch


def test_quick_command_on_the_cpu():
    """The default anchor preset shrunk by --quick, as a user runs it on
    the CPU (``--device cpu``; the default is the card)."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "tfhe_fbs_map_tpu_torch.bench",
                          "--quick", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) == JAX_KEYS | {"orientation", "bsk_limbs"}
    assert out["errors"] == 0 and out["device"] == "cpu"
    assert out["batch"] == 32 and out["orientation"] == "fused"
    assert out["bsk_limbs"] == 4
    assert out["params"] == {"n": 32, "k": 1, "N": 128, "l_bsk": 2, "p": 4}


@pytest.mark.parametrize("argv,orientation,limbs", [
    (["--orientation", "fused_otf"], "fused_otf", 4),
    (["--bsk-limbs", "3"], "fused", 3),
    (["--orientation", "keys_rhs"], "keys_rhs", 4),
    (["--orientation", "keys_lhs"], "keys_lhs", 4),
    (["--orientation", "keys_lhs_bf16"], "keys_lhs_bf16", 4),
])
def test_quick_flags(argv, orientation, limbs, capsys, tmp_path):
    """--orientation, --bsk-limbs and --trace reach the run."""
    logdir = tmp_path / "trace"
    rc = bench.main(["--quick", "--device", "cpu", "--iters", "2", "--batch",
                     "8", "--trace", str(logdir)] + argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["errors"] == 0 and out["batch"] == 8
    assert (out["orientation"], out["bsk_limbs"]) == (orientation, limbs)
    traces = list(logdir.glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())


@pytest.mark.parametrize("preset,kernel,gb", [
    ("anchor", "fused_otf", 10.3),
    ("p8", "fused_otf", 12.1),
    ("p16", "fused_otf", 32.3),
    ("p32", "fused_otf", 142.1),
])
def test_auto_pick_on_an_h100(preset, kernel, gb):
    """K2's matrices fit an H100 at the anchor, p8 and p16, but K1 is
    priced lower at each (the calibration's summed ``launch_us``); at p32
    they do not fit."""
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import fused_key_bytes
    params = PRESETS[preset][0]
    assert round(fused_key_bytes(params) / 1e9, 1) == gb
    got = bench.bench_orientation(params, "auto", 4, torch.device("cuda"),
                                  free_bytes=H100_FREE_MIB << 20)
    assert got == kernel


@pytest.fixture()
def fake_card(monkeypatch):
    """A CUDA device with an H100's free memory, on which nothing may be
    built: both bench runs raise."""
    from tfhe_fbs_map_tpu_torch.runtime import cli

    def no_build(*a, **k):
        raise AssertionError("keys were built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "free_memory", lambda dev: H100_FREE_MIB << 20)
    monkeypatch.setattr(bench, "native_bench", no_build)
    monkeypatch.setattr(bench, "staged_p32_bench", no_build)


@pytest.mark.parametrize("argv,why", [
    (["--preset", "p32", "--native-p32", "--orientation", "fused"],
     "K2's key matrices take 142.1 GB"),
    (["--preset", "p32", "--orientation", "fused"], "staged p32 lookup"),
    (["--preset", "p32", "--bsk-limbs", "3"], "staged p32 lookup"),
    (["--preset", "p32", "--orientation", "keys_lhs"], "staged p32 lookup"),
    (["--orientation", "keys_rhs", "--bsk-limbs", "3"],
     "keys_rhs keeps all 4 key limbs"),
    (["--preset", "p8", "--orientation", "keys_lhs"],
     "up to bsk_base_log 7, not 8"),
])
def test_kernel_that_cannot_run_exits_2(argv, why, fake_card, capsys):
    """No fallback: a kernel asked for that cannot run is refused before
    any key is built."""
    assert bench.main(argv) == 2
    out = capsys.readouterr()
    assert why in out.err and out.out == ""


def test_without_cuda_exits_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main([]) == 2
    assert bench.main(["--preset", "p32", "--native-p32"]) == 2
    # --quick runs on the card too, unless asked for the CPU
    assert bench.main(["--quick"]) == 2
    assert bench.main(["--preset", "p32", "--quick"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
