"""The port's runtime CLI, driven through ``main()`` as a user calls it, and
its pinned parameter presets against what the JAX package picks."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.tfhe.params import TFHEParams as JParams
from tfhe_fbs_map_tpu.tfhe.params import min_noise_std_rel as jnoise
from tfhe_fbs_map_tpu_torch.runtime.cli import (FUSED_HEADROOM, main,
                                                pick_orientations)
from tfhe_fbs_map_tpu_torch.tfhe.params import (PRESETS, STAGED_PRESETS,
                                                TEST_PARAMS)

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)


@pytest.fixture()
def full_adder_blif(tmp_path):
    path = tmp_path / "fa.blif"
    with open(path, "w") as f:
        build_bench("full_adder").to_blif(f, model_name="fa")
    return str(path)


def last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("orientation", ["generic", "fused", "fused_otf",
                                         "auto", "keys_rhs", "keys_lhs",
                                         "keys_lhs_bf16"])
def test_cpu_run_is_bit_exact(full_adder_blif, capsys, orientation):
    rc = main([full_adder_blif, "--map", "--fbs_size", "4", "--batch", "4",
               "--device", "cpu", "--test-params",
               "--orientation", orientation])
    res = last_json(capsys)
    assert rc == 0 and res["bit_exact"] and res["wrong_bits"] == 0
    assert res["orientation"] == ("generic" if orientation == "auto"
                                  else orientation)
    assert res["bootstraps"] >= 1 and res["batch"] == 4
    assert res["expected_flips"] is None and res["mesh"] is None


@pytest.mark.parametrize("orientation", ["keys_rhs", "keys_lhs",
                                         "keys_lhs_bf16"])
def test_conv_run_equals_the_jax_cli(full_adder_blif, capsys, monkeypatch,
                                     orientation):
    """``--orientation keys_*`` on the CPU against the JAX CLI with the same
    arguments: the final wire buffer bitwise and the same decoded outputs
    (same seed, same draws)."""
    from tfhe_fbs_map_tpu.runtime.cli import main as jax_cli
    from tfhe_fbs_map_tpu.runtime.executor import CircuitExecutor as JEx
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    runs = []
    for cls in (JEx, CircuitExecutor):
        decrypt = cls.decrypt_outputs

        def spy(self, buf, decrypt=decrypt):
            out = decrypt(self, buf)
            runs.append((np.asarray(buf), out))
            return out
        monkeypatch.setattr(cls, "decrypt_outputs", spy)
    argv = [full_adder_blif, "--map", "--batch", "4", "--test-params",
            "--orientation", orientation]
    assert jax_cli(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "bit_exact"]
    assert main(argv + ["--device", "cpu"]) == 0
    res = last_json(capsys)
    assert res["bit_exact"] and res["orientation"] == orientation
    assert res["bsk_limbs"] == 4
    (jbuf, jout), (buf, out) = runs
    assert np.array_equal(jbuf, buf)
    assert jout.keys() == out.keys()
    assert all(np.array_equal(np.asarray(jout[k]), out[k]) for k in out)


def test_keys_and_checkpoint_flags(full_adder_blif, capsys, tmp_path):
    keys = str(tmp_path / "k.npz")
    base = [full_adder_blif, "--map", "--batch", "2", "--device", "cpu",
            "--orientation", "generic"]
    assert main(base + ["--test-params", "--save-keys", keys]) == 0
    first = last_json(capsys)
    ckpt = str(tmp_path / "c.npz")
    assert main(base + ["--keys", keys, "--checkpoint", ckpt,
                        "--checkpoint-every", "1", "--repeat", "2"]) == 0
    second = last_json(capsys)
    assert first["bit_exact"] and second["bit_exact"]


def test_mesh_run_equals_one_device(full_adder_blif, capsys, monkeypatch):
    """``--mesh 4`` on the CPU: four positions, bit-exact, and the decoded
    outputs of the run without a mesh (same seed, same draws)."""
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    decoded = []
    decrypt = CircuitExecutor.decrypt_outputs

    def spy(self, buf):
        out = decrypt(self, buf)
        # the whole buffer, or under a mesh the list of shards (not each)
        if isinstance(buf, list) or self.mesh is None:
            decoded.append(out)
        return out
    monkeypatch.setattr(CircuitExecutor, "decrypt_outputs", spy)
    base = [full_adder_blif, "--map", "--batch", "8", "--device", "cpu",
            "--test-params", "--orientation", "fused_otf"]
    runs = []
    for extra in ([], ["--mesh", "4"]):
        assert main(base + extra) == 0
        out = capsys.readouterr()
        runs.append(json.loads(out.out.strip().splitlines()[-1]))
    assert "# mesh: dp=4 tp=1" in out.err
    one, mesh = runs
    assert one["mesh"] is None and mesh["mesh"] == {"dp": 4, "tp": 1}
    assert one["bit_exact"] and mesh["bit_exact"]
    assert len(decoded) == 2 and decoded[0].keys() == decoded[1].keys()
    for k in decoded[0]:
        assert np.array_equal(decoded[0][k], decoded[1][k]), k


@pytest.mark.parametrize("args,rc,why", [
    (["--batch", "6", "--mesh", "4"], 1, "divisible by dp=4"),
    (["--mesh", "2,2"], 2, "tp=2 is not supported"),
    (["--mesh", "2,2", "--orientation", "fused_otf"], 2,
     "is not supported by --orientation fused_otf: tp shards the key "
     "contraction of the matmul orientation alone (--orientation matmul)"),
    (["--mesh", "0"], 2, "want DP, DP,TP or auto"),
    (["--mesh", "x"], 2, "want DP, DP,TP or auto"),
])
def test_mesh_refusals(full_adder_blif, capsys, args, rc, why):
    """tp > 1 only under --orientation matmul (auto never picks it), and
    the message says so."""
    assert main([full_adder_blif, "--map", "--device", "cpu",
                 "--test-params", *args]) == rc
    out = capsys.readouterr()
    assert why in out.err and not out.out


def test_cuda_without_a_device_fails_clearly(full_adder_blif, capsys,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main([full_adder_blif, "--map", "--test-params"])
    err = capsys.readouterr().err
    assert rc != 0 and "no CUDA device" in err


@pytest.fixture()
def tiny_optimizer(monkeypatch):
    """The port's optimizer, monkeypatched to pick the tiny test families
    (``TEST_PARAMS`` native, the ``staged_test`` pair staged); records what
    the CLI asked it.  ``picks["native"]`` / ``picks["staged"]`` set to None
    make a search find nothing."""
    import tfhe_fbs_map_tpu_torch.optimizer as opt
    from tfhe_fbs_map_tpu_torch.optimizer.optimizer import (Solution,
                                                            StagedSolution)
    fams = STAGED_PRESETS["staged_test"]
    picks = {"native": True, "staged": True, "limbs": 4, "asked": []}

    def optimize(p, sq_norm2, **kw):
        picks["asked"].append(("native", p, sq_norm2, kw))
        return (Solution(TEST_PARAMS.with_p(p), 1.0, 1e-9, picks["limbs"])
                if picks["native"] else None)

    def optimize_staged(p, sq_norm1, sq_norm2, **kw):
        picks["asked"].append(("staged", p, sq_norm1, sq_norm2, kw))
        return (StagedSolution(fams.fam1, fams.fam2, 1.0, 2e-9)
                if picks["staged"] else None)
    monkeypatch.setattr(opt, "optimize", optimize)
    monkeypatch.setattr(opt, "optimize_staged", optimize_staged)
    return picks


def test_params_required(full_adder_blif, capsys, tiny_optimizer):
    """Without --params, --test-params or --keys the optimizer picks the
    parameters, and the run is bit-exact."""
    rc = main([full_adder_blif, "--map", "--device", "cpu"])
    res = last_json(capsys)
    assert rc == 0 and res["bit_exact"] and res["params_from"] == "optimizer"
    assert res["params"]["n"] == TEST_PARAMS.lwe_dim and not res["staged"]
    assert res["p_error"] == 1e-9 and res["bsk_limbs"] == 4
    assert res["expected_flips"] == round(1e-9 * res["bootstraps"] * 8, 3)
    # p=4: no staged search, the 4-sigma default target
    assert tiny_optimizer["asked"] == [("native", 4, 3, {})]


def test_aes128_preset_is_the_optimizer_pick():
    from tfhe_fbs_map_tpu.optimizer import optimize
    sol = optimize(4, 6, max_p_error=1e-7)
    params, p_error = PRESETS["aes128_p4"]
    assert vars(params) == vars(sol.params)
    assert p_error == sol.p_error and sol.bsk_limbs == 4


@pytest.mark.parametrize("name,tup", [
    # bench.py:80-103: (p, n, k, N, bsk_level, bsk_base_log, ksk_level,
    # ksk_base_log), noise on the security curve
    ("anchor", (4, 546, 2, 512, 2, 8, 4, 3)),
    ("p8", (8, 642, 2, 512, 2, 8, 6, 2)),
    ("p16", (16, 642, 1, 1024, 3, 6, 6, 2)),
    # bench.py:83, the family of --preset p32 --native-p32
    ("p32", (32, 706, 1, 2048, 3, 7, 7, 2)),
])
def test_bench_presets(name, tup):
    p, n, k, N, bl, bb, kl, kb = tup
    want = JParams(p=p, lwe_dim=n, glwe_dim=k, poly_size=N, bsk_level=bl,
                   bsk_base_log=bb, ksk_level=kl, ksk_base_log=kb,
                   lwe_noise_std=jnoise(n) * 2.0 ** 32,
                   glwe_noise_std=jnoise(k * N) * 2.0 ** 32)
    assert vars(PRESETS[name][0]) == vars(want)


def pick_orientation(params, device, free_bytes=None):
    return pick_orientations([params], device, free_bytes)[0]


def test_auto_orientation_by_free_memory(monkeypatch):
    """AES-128's K2 matrices (10.9 GB) fit a card with 79 GiB free, and K1
    is priced lower there (``runtime_model.kernel_us``): K1 whatever the
    memory.  Where K2 is priced lower (K1 charged 60 ms a launch), K2 runs
    when its matrices fit and K1 when they do not."""
    import copy
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import fused_key_bytes
    from tfhe_fbs_map_tpu_torch.optimizer import runtime_model as rm
    params = PRESETS["aes128_p4"][0]
    assert fused_key_bytes(params) == 578 * 3072 * 6144
    assert np.isclose(fused_key_bytes(params) / 1e9, 10.9, atol=0.05)
    cuda = torch.device("cuda")
    assert pick_orientation(params, cuda, free_bytes=79 << 30) == "fused_otf"
    assert pick_orientation(params, cuda, free_bytes=12 << 30) == "fused_otf"
    assert pick_orientation(params, torch.device("cpu")) == "generic"
    cal = copy.deepcopy(rm.calibration())
    cal["families"][rm.entry_key(params, "fused_otf")]["fixed_us"] = 60e3
    monkeypatch.setattr(rm, "calibration", lambda: cal)
    assert rm.kernel_us(params, "fused") < rm.kernel_us(params, "fused_otf")
    assert pick_orientation(params, cuda, free_bytes=79 << 30) == "fused"
    assert pick_orientation(params, cuda, free_bytes=12 << 30) == "fused_otf"


AUTO_CASES = [
    ("bsk_base_log", 9, None, None),      # digits no longer fit int8
    ("bsk_level", 4, None, None),         # b·l = 32
    ("poly_size", 16, None, None),        # N not a multiple of 32
    ("poly_size", 96, None, None),        # N not a power of two
    ("poly_size", 8192, "fused", None),   # above the largest N K1 serves
    ("poly_size", 64, "fused", "fused_otf"),  # K1 through its small-N kernel
]


@pytest.mark.parametrize("field,value,auto,tight", AUTO_CASES,
                         ids=[f"{f}-{v}-{a}" for f, v, a, _ in AUTO_CASES])
def test_auto_orientation_refuses_what_no_kernel_serves(field, value, auto,
                                                        tight):
    """On CUDA ``auto`` picks a kernel that can serve the parameters or
    raises: it never falls back to the plain bootstrap on the card.
    ``auto``: its pick with room for K2's matrices; ``tight``: with 1 GB,
    where only K1 can run (None: it raises)."""
    from dataclasses import replace
    from tfhe_fbs_map_tpu_torch.runtime.cli import check_kernel
    params = replace(PRESETS["aes128_p4"][0], **{field: value})
    cuda = torch.device("cuda")
    assert pick_orientation(params, torch.device("cpu")) == "generic"
    if tight is None:
        with pytest.raises(ValueError, match="--orientation generic"):
            check_kernel(params, "fused_otf")
    else:
        check_kernel(params, "fused_otf")
    if auto is None:
        with pytest.raises(ValueError, match="--orientation generic"):
            pick_orientation(params, cuda, free_bytes=1 << 50)
    else:
        assert pick_orientation(params, cuda, free_bytes=1 << 50) == auto
    if tight is None:
        with pytest.raises(ValueError, match="fused_otf"):
            pick_orientation(params, cuda, free_bytes=1 << 30)
    else:
        assert pick_orientation(params, cuda, free_bytes=1 << 30) == tight


# ------------------------------------------------------------- staged

@pytest.fixture()
def mixed_lbf(tmp_path):
    """A p=32 program with every staged route (test_staged_executor's)."""
    from test_staged_executor import build_mixed_program
    prog = build_mixed_program(np.random.default_rng(2))
    prog.fbs_size = 32
    path = tmp_path / "mixed.lbf"
    with open(path, "w") as f:
        prog.write_lbf(f)
    return str(path)


@pytest.mark.parametrize("orientation,staged", [
    ("generic", "auto"), ("fused_otf", "on"), ("auto", "auto")])
def test_staged_preset_runs_bit_exact(mixed_lbf, capsys, orientation,
                                      staged):
    rc = main([mixed_lbf, "--params", "staged_test", "--staged", staged,
               "--batch", "3", "--device", "cpu",
               "--orientation", orientation])
    res = last_json(capsys)
    assert rc == 0 and res["staged"] and res["bit_exact"]
    want = "generic" if orientation == "auto" else orientation
    assert res["orientation"] == {"fam1": want, "fam2": want}
    assert res["bootstraps"] == 4 and res["batch"] == 3
    assert res["expected_flips"] is None


@pytest.mark.parametrize("args,why", [
    (["--params", "staged_test", "--staged", "off"], "--staged off"),
    (["--params", "test", "--staged", "on"], "--staged on"),
    (["--test-params", "--staged", "on"], "--staged on"),
    (["--params", "staged_test", "--keys", "k.npz"], "--keys"),
    (["--params", "kreyvium_p10_staged"], "p=10"),
])
def test_staged_mismatches_exit_2(mixed_lbf, capsys, args, why):
    rc = main([mixed_lbf, "--device", "cpu", *args])
    assert rc == 2 and why in capsys.readouterr().err


@pytest.mark.parametrize("name,p,norms,kw", [
    # the keyless staged probe of the Kreyvium-1152 program
    # (test_torch_staged_executor.py): eff norms 27/25, 8754 f1 + 93 f2
    ("kreyvium_p10_staged", 10, (27, 25),
     dict(weight1=8754, weight2=93, wires_from_stage2=False,
          max_p_error=1e-7)),
    # bench.py:243-252
    ("p32_staged", 32, (4, 2), dict(max_p_error=1e-6)),
])
def test_staged_presets_are_the_optimizer_picks(name, p, norms, kw):
    from tfhe_fbs_map_tpu.optimizer.optimizer import optimize_staged
    sol = optimize_staged(p, *norms, **kw)
    preset = STAGED_PRESETS[name]
    assert preset.p == p
    assert vars(preset.fam1) == vars(sol.params1)
    assert vars(preset.fam2) == vars(sol.params2)
    assert preset.p_error == sol.p_error


@pytest.mark.parametrize("name", ["kreyvium_p10_staged", "p32_staged"])
def test_auto_staged_orientations_fit_together(name):
    """``auto`` sends both staged families to K1, even where their K2
    matrices (59-67 GB) fit an 80 GB card's free memory together, as they
    do at both presets; fam1 alone, as a native family, takes the kernel
    of the lower calibrated price, K1 at both."""
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import fused_key_bytes
    preset = STAGED_PRESETS[name]
    fams = [preset.fam1, preset.fam2]
    sizes = [fused_key_bytes(f) for f in fams]
    want = {"kreyvium_p10_staged": [642 * 8192 * 8192, 642 * 6144 * 6144],
            "p32_staged": [674 * 6144 * 8192, 674 * 6144 * 6144]}[name]
    assert sizes == want
    # an H100 80GB HBM3 holds 81,559 MiB
    card = 81559 << 20
    assert sum(sizes) + FUSED_HEADROOM < card
    cuda = torch.device("cuda")
    assert pick_orientations(fams, cuda, free_bytes=card) \
        == ["fused_otf"] * 2
    assert pick_orientations(fams[:1], cuda, free_bytes=card) \
        == ["fused_otf"]
    assert pick_orientations(fams, torch.device("cpu")) == ["generic"] * 2


# bench.py:355-372, the JAX staged bench's JSON keys
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "batch", "staged",
              "params", "device", "keygen_s", "compile_s",
              "ms_per_bootstrap", "errors"}


def test_bench_p32_quick_on_the_cpu():
    root = Path(__file__).resolve().parents[1]
    # one thread, as in this process: the test workers share the cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run([sys.executable, "-m", "tfhe_fbs_map_tpu_torch.bench",
                          "--preset", "p32", "--quick", "--device", "cpu"],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out) == BENCH_KEYS
    assert out["errors"] == 0 and out["staged"] and out["device"] == "cpu"
    assert out["batch"] == 5 * 8
    assert out["params"] == {"n": 16, "p": 32,
                             "fam1": {"k": 1, "N": 256, "l_bsk": 3},
                             "fam2": {"k": 2, "N": 128, "l_bsk": 3}}


# ------------------------------------------- the optimizer and the routing

MODEL_LINE = re.compile(r"# runtime model \(batch 3\): native [\d.]+ms/eval, "
                        r"staged [\d.]+ms/eval")


def run_json(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, (json.loads(out.out.strip().splitlines()[-1]) if rc != 2
                and out.out.strip() else None), out.err


def test_optimizer_routes_by_the_runtime_model(mixed_lbf, capsys,
                                               tiny_optimizer):
    """A p=32 program takes the staged probe and both searches at the
    target asked, prints the runtime model's line and routes by it;
    ``--staged-margin`` flips the route."""
    base = [mixed_lbf, "--batch", "3", "--device", "cpu", "--p-error",
            "1e-7"]
    rc, res, err = run_json(capsys, base)
    assert rc == 0 and res["bit_exact"] and MODEL_LINE.search(err)
    eff1, eff2, norm2 = probe(mixed_lbf)
    assert tiny_optimizer["asked"] == [
        ("staged", 32, eff1, eff2,
         dict(max_p_error=1e-7, weight1=3, weight2=3,
              wires_from_stage2=False)),
        ("native", 32, norm2, dict(max_p_error=1e-7))]
    native, staged = (res["predicted"]["native_run_s"],
                      res["predicted"]["staged_run_s"])
    assert 0 < native and 0 < staged
    assert res["staged"] == (staged < native)
    ratio = staged / native
    for margin, want in ((ratio * 2, True), (ratio / 2, False)):
        rc, res, err = run_json(capsys, base + ["--staged-margin",
                                                str(margin)])
        assert rc == 0 and res["bit_exact"] and res["staged"] == want
        assert res["params"].keys() == ({"fam1", "fam2"} if want
                                        else _family_keys())


def probe(path):
    """The staged probe's effective norms of a p=32 program, and its
    norm2_linprod."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.runtime.executor import staged_probe
    with open(path) as f:
        prog = parse_lbf(f.read())
    eff1, eff2, _ = staged_probe(prog, 32)
    return eff1, eff2, prog.stats()["norm2_linprod"]


def _family_keys():
    return {"p", "n", "k", "N", "l_bsk", "b_bsk", "l_ksk", "b_ksk"}


@pytest.mark.parametrize("staged", ["on", "off"])
def test_optimizer_honours_staged_on_and_off(mixed_lbf, capsys,
                                             tiny_optimizer, staged):
    rc, res, err = run_json(capsys, [mixed_lbf, "--batch", "3", "--device",
                                     "cpu", "--staged", staged])
    assert rc == 0 and res["bit_exact"]
    assert res["staged"] == (staged == "on")
    asked = [a[0] for a in tiny_optimizer["asked"]]
    assert asked == (["staged", "native"] if staged == "on" else ["native"])
    assert bool(MODEL_LINE.search(err)) == (staged == "on")
    assert res["p_error"] == (2e-9 if staged == "on" else 1e-9)


def test_optimizer_bsk_limbs_reach_the_fast_keys(full_adder_blif, capsys,
                                                 tiny_optimizer,
                                                 monkeypatch):
    from tfhe_fbs_map_tpu_torch.ops import blind_rotate as br
    tiny_optimizer["limbs"] = 3
    seen = []
    prepare = br.prepare_fast_keys

    def spy(keys, orientation="fused", bsk_limbs=4):
        seen.append((orientation, bsk_limbs))
        return prepare(keys, orientation=orientation, bsk_limbs=bsk_limbs)
    monkeypatch.setattr(br, "prepare_fast_keys", spy)
    rc, res, _ = run_json(capsys, [full_adder_blif, "--map", "--batch", "4",
                                   "--device", "cpu", "--orientation",
                                   "fused"])
    assert rc == 0 and seen == [("fused", 3)] and res["bsk_limbs"] == 3
    assert res["orientation"] == "fused"


@pytest.mark.parametrize("native,staged,args", [
    (False, False, []),                   # no parameters at all
    (True, False, ["--staged", "on"]),    # staged asked for, none found
])
def test_optimizer_without_parameters_exits_1(mixed_lbf, capsys,
                                              tiny_optimizer, native,
                                              staged, args):
    tiny_optimizer["native"], tiny_optimizer["staged"] = native, staged
    rc = main([mixed_lbf, "--batch", "3", "--device", "cpu", *args])
    out = capsys.readouterr()
    assert rc == 1 and not out.out
    assert ("no parameter set" if not native else "--staged on") in out.err


def test_optimizer_without_parameters_on_a_small_program(
        full_adder_blif, capsys, tiny_optimizer):
    tiny_optimizer["native"] = False
    assert main([full_adder_blif, "--map", "--device", "cpu"]) == 1
    assert "no parameter set" in capsys.readouterr().err
