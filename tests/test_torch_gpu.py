"""CUDA kernels of the PyTorch port against their plain versions (needs a
GPU; skips without one).  This file imports no JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

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


# each kernel at the plans k1_plan / k2_plan pick (132 SMs) for the main
# path's batch sizes, forced where the card has another SM count
BATCHES = (1, 21, 64, 512, 1024)
K1_PLANS = sorted({(b, p.cb, p.cluster, p.nw) for b in BATCHES
                   for p in [fbr.k1_plan(b, TEST_PARAMS, 132)]})
K2_PLANS = sorted({(b, p.cb, p.cluster) for b in BATCHES
                   for p in [fbr.k2_plan(b, TEST_PARAMS, 132)]})


@pytest.mark.parametrize("otf,batch,plan",
                         [(True, b, (cb, c, w)) for b, cb, c, w in K1_PLANS]
                         + [(False, b, (cb, c)) for b, cb, c in K2_PLANS])
def test_kernel_equals_plain_every_tile(cuda, otf, batch, plan):
    args = operands(TEST_PARAMS, batch, otf, seed=1)
    dev = [x.to(cuda) for x in args]
    key = "k1" if otf else "k2"
    if otf:
        plain = fbr.blind_rotate_k1_plain(*dev, TEST_PARAMS).cpu()
        kw = dict(batch_tile=plan[0], cluster=plan[1], nw=plan[2])
    else:
        plain = fbr.blind_rotate_k2_plain(*dev, TEST_PARAMS).cpu()
        kw = dict(batch_tile=plan[0], cluster=plan[1])
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


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_bench_chain_on_cuda_equals_plain(cuda, orientation, key,
                                          monkeypatch):
    """The bench's XOR chain at the anchor's shape with n cut to 16, three
    steps through the kernel, is bitwise equal on the card to the same chain
    through the kernel's plain version, and decrypts right."""
    from dataclasses import replace

    from tfhe_fbs_map_tpu_torch import bench
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS
    params = replace(PRESETS["anchor"][0], lwe_dim=16)
    keys = generate_keys(params, seed=1, device=cuda)
    fast = prepare_fast_keys(keys, orientation=orientation)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fbr, "blind_rotate_k1", lambda *a: (
                fbr.blind_rotate_k1_plain(*a[:5])))
            monkeypatch.setattr(fbr, "blind_rotate_k2", lambda *a: (
                fbr.blind_rotate_k2_plain(*a[:5])))
        chain = bench.XorChain(keys, fast, 64)
        before = fbr.LAUNCHES[key]
        for _ in range(3):
            chain.step()
        torch.cuda.synchronize()
        runs.append((chain, fbr.LAUNCHES[key] - before))
    (kern, launched), (ref, launched_plain) = runs
    assert (launched, launched_plain) == (3, 0)
    assert torch.equal(kern.cts, ref.cts)
    assert kern.wrong(3) == 0


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_staged_bootstrap_on_cuda_equals_generic(cuda, orientation, key):
    """At the p32_staged families with n cut to 16, the staged bootstrap
    with both stages through a fused kernel is bitwise equal to the generic
    staged bootstrap on the card, and decrypts to the table."""
    from dataclasses import replace

    from tfhe_fbs_map_tpu_torch.tfhe.encrypt import lwe_phase
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import (
        encrypt_wires, generate_staged_keys, split_node,
        staged_functional_bootstrap)
    preset = STAGED_PRESETS["p32_staged"]
    fam1, fam2 = (replace(f, lwe_dim=16) for f in (preset.fam1, preset.fam2))
    skeys = generate_staged_keys(32, fam1, fam2, seed=3, device=cuda)
    coefs = [1, 2, 4, 8, 16]
    rng = np.random.default_rng(4)
    table = rng.integers(0, 2, 32).tolist()
    split = split_node(coefs, 0, table, 32)
    combos = np.array([[(j >> i) & 1 for j in range(32)] for i in range(5)])
    cts = torch.stack([encrypt_wires(skeys, combos[i], rng)
                       for i in range(5)])
    want = staged_functional_bootstrap(skeys, split, cts, coefs)
    fast = [prepare_fast_keys(k, orientation=orientation)
            for k in (skeys.keys1, skeys.keys2)]
    before = fbr.LAUNCHES[key]
    got = staged_functional_bootstrap(skeys, split, cts, coefs,
                                      fast1=fast[0], fast2=fast[1])
    torch.cuda.synchronize()
    assert fbr.LAUNCHES[key] == before + 2
    assert torch.equal(got, want)
    u = lwe_phase(skeys.extracted_key, got).cpu().numpy().astype(np.uint32)
    dec = np.round(u / skeys.wire_params.delta).astype(np.int64) % 64
    assert np.array_equal(dec, np.asarray(table)[coefs @ combos])


def mixed_program(rng):
    """A p=32 program with every staged route: two splits (one of them
    negacyclic), an f2 single and an f1 single, with fanout at mixed
    multipliers (tests/test_staged_executor.py's, on the port's
    frontend)."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import LutProgram
    prog = LutProgram()
    w = [prog.input(f"w{i}") for i in range(5)]

    def tbl(n):
        t = rng.integers(0, 2, n)
        t[rng.integers(0, n)] = 0
        return t.tolist()

    addr = prog.linear([1, 2, 4, 8, 16], w, 0)
    a = prog.bootstrap(addr, tbl(addr.max_val + 1))
    lin_b = prog.linear([1, 2], [a, w[0]], 0)
    b = prog.bootstrap(lin_b, tbl(lin_b.max_val + 1))
    lin_c = prog.linear([1, 2, 4, 5], [b, w[1], w[2], a], 0)
    c = prog.bootstrap(lin_c, tbl(lin_c.max_val + 1))
    half = rng.integers(0, 2, 32)
    d = prog.bootstrap(prog.linear([1, 2, 4, 8, 16, 32], w + [c], 0),
                       half.tolist() + (1 - half).tolist())
    prog.output("o_split", a)
    prog.output("o_small", b)
    prog.output("o_mid", c)
    prog.output("o_nega", d)
    prog.output("o_lin", prog.linear([1, 2], [a, d], 0))
    return prog


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_staged_executor_on_cuda_equals_generic(cuda, orientation, key):
    """``CircuitExecutor.step`` on the card through a fused kernel, at the
    p32_staged families with n cut to 16, over a program with split levels:
    the wire buffer after every level is bitwise equal to the generic
    staged run's on the card, the kernel launches once per non-empty family
    call, and the outputs decrypt to the oracle."""
    from dataclasses import replace

    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
    preset = STAGED_PRESETS["p32_staged"]
    fam1, fam2 = (replace(f, lwe_dim=16) for f in (preset.fam1, preset.fam2))
    skeys = generate_staged_keys(32, fam1, fam2, seed=3, device=cuda)
    rng = np.random.default_rng(2)
    prog = mixed_program(rng)
    fast = tuple(prepare_fast_keys(k, orientation=orientation)
                 for k in (skeys.keys1, skeys.keys2))
    ex = CircuitExecutor(prog, skeys, fast_keys=fast)
    ref = CircuitExecutor(prog, skeys)
    assert ex.plan.route_counts == {"f1": 1, "f2": 1, "split": 2}
    values = {f"w{i}": rng.integers(0, 2, 16) for i in range(5)}
    buf = ex.encrypt_inputs(values, np.random.default_rng(5))
    want = buf.clone()
    calls, before = 0, fbr.LAUNCHES[key]
    for lv, plan in enumerate(ex.levels):
        buf = ex.step(buf, lv)
        want = ref.step(want, lv)
        assert torch.equal(buf, want), (lv, plan.n_splits)
        calls += bool(plan.wire_idx1.shape[0]) + bool(plan.wire_idx2.shape[0])
    torch.cuda.synchronize()
    assert fbr.LAUNCHES[key] == before + calls
    got = ex.decrypt_outputs(buf)
    for k, w in prog.eval(values).items():
        assert np.array_equal(got[k] % 64, np.asarray(w) % 64), k


def test_cli_on_cuda(cuda, tmp_path, capsys):
    from tfhe_fbs_map_tpu_torch.frontend import BitCircuit
    from tfhe_fbs_map_tpu_torch.runtime.cli import main
    fa = BitCircuit()
    a, b, cin = (fa.add_input(n) for n in ("a", "b", "cin"))
    p = fa.xor_(a, b)
    fa.set_output("out", fa.xor_(p, cin))
    fa.set_output("cout", fa.or_(fa.and_(a, b), fa.and_(p, cin)))
    blif = tmp_path / "fa.blif"
    with open(blif, "w") as f:
        fa.to_blif(f, model_name="fa")
    for orientation, key in (("fused", "k2"), ("fused_otf", "k1")):
        before = fbr.LAUNCHES[key]
        rc = main([str(blif), "--map", "--batch", "4", "--test-params",
                   "--orientation", orientation])
        res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and res["bit_exact"]
        assert fbr.LAUNCHES[key] > before


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_sharded_bootstrap_on_one_card(cuda, orientation, key):
    """Two dp shards on one card, each one launch of the kernel, bitwise
    equal to the one-device launch."""
    from tfhe_fbs_map_tpu_torch.parallel import (make_mesh, shard_batch,
                                                 sharded_bootstrap)
    keys = generate_keys(TEST_PARAMS, seed=4, device=cuda)
    fast = prepare_fast_keys(keys, orientation=orientation)
    values = np.random.default_rng(5).integers(0, 2, 128)
    cts = encrypt_values(keys, values, np.random.default_rng(6))
    tv, post = build_test_vector([0, 1], TEST_PARAMS)
    tvs = torch.from_numpy(np.tile(tv, (len(values), 1))).to(cuda)
    posts = torch.full((len(values),), post, dtype=torch.int32, device=cuda)
    want = functional_bootstrap_fast(fast, cts, tvs, posts)
    mesh = make_mesh([cuda, cuda])
    shards = [shard_batch(mesh, x) for x in (cts, tvs, posts)]
    before = dict(fbr.LAUNCHES)
    got = sharded_bootstrap(mesh, fast)(*shards)
    torch.cuda.synchronize()
    assert {k: fbr.LAUNCHES[k] - before[k] for k in before} \
        == {key: 2, ("k2" if key == "k1" else "k1"): 0}
    assert torch.equal(torch.cat(got), want)


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_mesh_executor_on_one_card(cuda, orientation, key):
    """The full adder (the dry run's) through the executor on two shards of
    one card: the final wire buffer bitwise equal to one device's, the
    decryptions to the circuit's, one launch a level a shard."""
    from tfhe_fbs_map_tpu_torch.parallel import dryrun, make_mesh
    res = dryrun.full_adder(make_mesh([cuda, cuda]), TEST_PARAMS,
                            orientation, 8)
    assert res["bit_exact"]
    assert res["launches"][key] == 2 * res["levels"]


def test_level_step_issues_without_a_host_sync(cuda):
    """A native level step through K1 never waits for the card: under a
    mesh the host issues every shard's level while the others run."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import LutProgram
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    keys = generate_keys(TEST_PARAMS, seed=4, device=cuda)
    fast = prepare_fast_keys(keys, orientation="fused_otf")
    prog = LutProgram()
    a, b = prog.input("a"), prog.input("b")
    x = prog.bootstrap(prog.linear([1, 1], [a, b], 0), [0, 1, 0])
    prog.output("y", prog.bootstrap(prog.linear([1, 1], [x, a], 0),
                                    [1, 0, 1]))
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    assert len(ex.levels) == 2
    values = {n: np.ones(16, np.int64) for n in ("a", "b")}
    buf = ex.encrypt_inputs(values, np.random.default_rng(2))
    ex.step(buf.clone(), 0)               # builds and plans K1 once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for lv in range(len(ex.levels)):
            buf = ex.step(buf, lv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("orientation", ["fused", "fused_otf"])
def test_model_waves_equal_the_device_plan(cuda, orientation):
    """The runtime model plans every launch as the card does: the same
    plan and waves as ``device_plan`` / ``k1_device_plan`` (on the route,
    tile and cluster the cost model chooses) with the card's resident
    clusters, from the calibration's table alone."""
    from tfhe_fbs_map_tpu_torch.optimizer.optimizer import calibration
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import (
        launch_choice, launch_plan)
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, STAGED_PRESETS
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if sms != calibration()["sms"]:
        pytest.skip(f"the calibration's card has {calibration()['sms']} "
                    f"SMs, this one {sms}")
    otf = orientation == "fused_otf"
    krey = STAGED_PRESETS["kreyvium_p10_staged"]
    for params in (PRESETS["aes128_p4"][0], krey.fam1, krey.fam2):
        for limbs in (3, 4):
            for rows in (8, 64, 512, 1024, 2048, 4096, 8192, 20000):
                plan, waves = launch_plan(params, rows, orientation, limbs)
                c = launch_choice(params, rows, 1, orientation, limbs)
                got = (fbr.k1_device_plan(rows, params, cuda, limbs,
                                          *(c.tile or (None, None)),
                                          route=c.route) if otf
                       else fbr.device_plan(rows, params, cuda, limbs))
                fit = (fbr.k1_resident(got, params, limbs) if otf
                       else fbr.k2_max_clusters(got, limbs))
                clusters = -(-(-(-rows // got.cb))
                             // getattr(got, "pair", 1))
                assert (plan, waves) == (got, -(-clusters // max(1, fit)))


@pytest.mark.parametrize("limbs", [4, 3, 2, 1])
def test_k1_layout_fits_the_card(cuda, limbs):
    """The kernel sizes its ring: 4-6 stages in the 227 KB a CTA may have,
    for every (tile, width) it is instantiated for."""
    for cb in fbr.K1_TILES:
        for nw in fbr.K1_WIDTHS:
            if not fbr.k1_fits(cb, nw, limbs):
                continue
            stages, smem = fbr.k1_layout(fbr.K1Plan(cb, 1, nw), limbs)
            assert 4 <= stages <= 6 and 0 < smem <= fbr.SMEM_MAX
            for pair in fbr.K1_PAIRS:  # one tile a cluster, or two
                assert fbr.k1_max_clusters(fbr.K1Plan(cb, 2, nw, pair),
                                           limbs) >= 1


GIVE_UP = """
import sys
import torch
from tfhe_fbs_map_tpu_torch.ops import _build, fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.tfhe import TEST_PARAMS as P
path = _build.BUILD_DIR / "k1_spin0" / "k1.so"
_build.compile_library([_build.CSRC / "fused_blind_rotate.cu"], path,
                       ("-DFBR_SPIN=0",))
lib = _build.bind(path, ("k1",))
g = torch.Generator(device="cuda").manual_seed(3)
N, k1, rows = P.poly_size, P.glwe_dim + 1, (P.glwe_dim + 1) * P.bsk_level
def rand(lo, hi, shape, dtype):
    return torch.randint(lo, hi, shape, generator=g, device="cuda",
                         dtype=dtype)
args = (rand(0, 2 * N, (64, 1), torch.int32),
        rand(0, 2 * N, (P.lwe_dim, 64, 1), torch.int32),
        rand(-2 ** 31, 2 ** 31, (64, N), torch.int32),
        rand(-128, 128, (P.lwe_dim, 4 * k1, rows, 2 * N), torch.int8))
try:
    fbr._launch_k1(*args, P, None, None, None, lib)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("launch failed:", e)
    sys.exit(3)
print("launch succeeded")
"""


def test_k1_wait_that_gives_up_fails_the_launch(cuda):
    """Built with FBR_SPIN=0, every mbarrier wait of K1 gives up at once: the
    launch must end with a CUDA error, not with a wrong result.  The trap
    leaves the process's CUDA context unusable, so it runs in a child."""
    res = subprocess.run([sys.executable, "-c", GIVE_UP],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 3, res.stdout + res.stderr


def full_adder_program():
    """The full adder mapped by the basic mapper: three levels in two level
    groups, the first of two levels."""
    from tfhe_fbs_map_tpu_torch.frontend import BasicMapper, BitCircuit
    fa = BitCircuit()
    a, b, cin = (fa.add_input(n) for n in ("a", "b", "cin"))
    p = fa.xor_(a, b)
    fa.set_output("s", fa.xor_(p, cin))
    fa.set_output("cout", fa.or_(fa.and_(a, b), fa.and_(p, cin)))
    prog = BasicMapper().map(fa)
    prog.remove_dangling_nodes()
    return prog


def path_executor(cuda, path):
    """(executor, input buffer, family calls a run, kernel counter) for a
    path: native through K1 (``fused_otf``), K2 (``fused``) or the generic
    bootstrap at the test parameters, or the staged pair through K1 at the
    p32_staged families with n cut to 16."""
    from dataclasses import replace

    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
    rng = np.random.default_rng(2)
    if path == "staged":
        preset = STAGED_PRESETS["p32_staged"]
        fam1, fam2 = (replace(f, lwe_dim=16)
                      for f in (preset.fam1, preset.fam2))
        keys = generate_staged_keys(32, fam1, fam2, seed=3, device=cuda)
        fast = tuple(prepare_fast_keys(k, orientation="fused_otf")
                     for k in (keys.keys1, keys.keys2))
        prog, key = mixed_program(rng), "k1"
    else:
        keys = generate_keys(TEST_PARAMS, seed=4, device=cuda)
        fast = (None if path == "generic"
                else prepare_fast_keys(keys, orientation=path))
        prog = full_adder_program()
        key = {"fused_otf": "k1", "fused": "k2", "generic": None,
               "matmul": None, "keys_rhs": None, "keys_lhs": None,
               "keys_lhs_bf16": None}[path]
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    values = {n.name: rng.integers(0, 2, 16)
              for n in prog.nodes if n.kind == "input"}
    buf = ex.encrypt_inputs(values, np.random.default_rng(5))
    calls = (sum(bool(lv.wire_idx1.shape[0]) + bool(lv.wire_idx2.shape[0])
                 for lv in ex.levels) if ex.staged else len(ex.levels))
    return ex, buf, calls, key


PATHS = ["fused_otf", "fused", "generic", "staged", "matmul", "keys_rhs",
         "keys_lhs", "keys_lhs_bf16"]


@pytest.mark.parametrize("path", PATHS)
def test_graph_replay_equals_the_eager_loop(cuda, path):
    """``run`` replays one CUDA graph a level group: its buffer is bitwise
    equal to the eager level loop's, the capture launches nothing, and each
    replay adds each kernel's launches of a run."""
    ex, buf, calls, key = path_executor(cuda, path)
    assert len(ex.groups) < len(ex.levels) or path == "staged"
    want = buf.clone()
    for lv in range(len(ex.levels)):
        want = ex.step(want, lv)
    torch.cuda.synchronize()
    before = dict(fbr.LAUNCHES)
    assert ex.capture(buf) == len(ex.launch_groups(buf.shape[1]))
    torch.cuda.synchronize()
    assert fbr.LAUNCHES == before
    assert ex.capture(buf) == 0
    for i in range(2):
        got = ex.run(buf)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert got.data_ptr() != buf.data_ptr()
    grew = {k: fbr.LAUNCHES[k] - before[k] for k in before}
    assert grew == {k: 2 * calls * (k == key) for k in grew}


def test_graph_replay_counts_k1_by_kernel(cuda):
    """A graph's capture adds nothing to ``K1_KERNELS`` and its replay adds
    K1's launches by kernel as the eager level loop makes them: here the
    full adder at AES-128's family, whose launches of 16 ciphertexts take
    the small-tile plan."""
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS
    keys = generate_keys(PRESETS["aes128_p4"][0], seed=4, device=cuda)
    fast = prepare_fast_keys(keys, orientation="fused_otf")
    ex = CircuitExecutor(full_adder_program(), keys, fast_keys=fast)
    rng = np.random.default_rng(2)
    values = {n.name: rng.integers(0, 2, 16)
              for n in ex.prog.nodes if n.kind == "input"}
    buf = ex.encrypt_inputs(values, np.random.default_rng(5))
    before = dict(fbr.K1_KERNELS)
    want = buf.clone()
    for lv in range(len(ex.levels)):
        want = ex.step(want, lv)
    torch.cuda.synchronize()
    eager = {k: fbr.K1_KERNELS[k] - n for k, n in before.items()}
    assert eager["k1s_kernel_wide"] == len(ex.levels)
    before = dict(fbr.K1_KERNELS)
    assert ex.capture(buf) == len(ex.launch_groups(buf.shape[1]))
    torch.cuda.synchronize()
    assert fbr.K1_KERNELS == before
    got = ex.run(buf)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert {k: fbr.K1_KERNELS[k] - n for k, n in before.items()} == eager


def test_graphs_of_two_shards_on_one_card(cuda):
    """Under a mesh of two positions on one card each shard has its own
    static buffer and graphs: the shards equal the one-device run's, and a
    run launches K1 once a level a shard."""
    from tfhe_fbs_map_tpu_torch.parallel import make_mesh, shard_batch
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    ex, buf, calls, _ = path_executor(cuda, "fused_otf")
    want = ex.run(buf)
    mesh = make_mesh([cuda, cuda])
    two = CircuitExecutor(ex.prog, ex.keys, fast_keys=ex.fast_keys,
                          mesh=mesh)
    shards = shard_batch(mesh, buf, axis=1)
    assert two.capture(shards) == 2 * len(
        two.launch_groups(shards[0].shape[1]))
    before = fbr.LAUNCHES["k1"]
    got = two.run(shards)
    torch.cuda.synchronize()
    assert fbr.LAUNCHES["k1"] - before == 2 * calls
    assert torch.equal(torch.cat(got, dim=1), want)


@pytest.mark.parametrize("path", ["fused", "generic", "staged", "matmul",
                                  "keys_rhs", "keys_lhs", "keys_lhs_bf16"])
def test_level_step_is_sync_free_on_every_path(cuda, path):
    """K2's, the generic bootstrap's, the staged pair's, the matmul
    orientation's and the conv orientations' level steps never wait for
    the card either (K1's: ``test_level_step_issues_without_a_host_sync``)."""
    ex, buf, _, _ = path_executor(cuda, path)
    ex.step(buf.clone(), 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for lv in range(len(ex.levels)):
            buf = ex.step(buf, lv)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


SYNC_IN_CAPTURE = """
import sys
import numpy as np
import torch
from tfhe_fbs_map_tpu_torch.frontend.lut_program import LutProgram
from tfhe_fbs_map_tpu_torch.runtime import executor
from tfhe_fbs_map_tpu_torch.tfhe import TEST_PARAMS, generate_keys
keys = generate_keys(TEST_PARAMS, seed=4, device="cuda")
prog = LutProgram()
x = prog.bootstrap(prog.input("a"), [0, 1])
prog.output("y", prog.bootstrap(x, [1, 0]))
ex = executor.CircuitExecutor(prog, keys)
buf = ex.encrypt_inputs({"a": np.ones(4, np.int64)},
                        np.random.default_rng(1))
inner = executor._lincomb_flat
def synced(*args):
    out = inner(*args)
    if out.sum().item() == 0.5:
        print("unreachable")
    return out
executor._lincomb_flat = synced
try:
    ex.run(buf)
except RuntimeError as e:
    print("capture raised:", e)
    sys.exit(3)
print("run returned")
"""


def test_a_capture_that_meets_a_sync_raises(cuda):
    """A host sync inside a level makes ``run``'s capture raise; nothing
    falls back to the eager loop.  A failed capture can leave the CUDA
    context unusable, so it runs in a child."""
    res = subprocess.run([sys.executable, "-c", SYNC_IN_CAPTURE],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 3, res.stdout + res.stderr


def test_graphs_die_with_the_executor(cuda):
    """The graphs, their memory pool and the static buffers belong to the
    executor: once it is deleted and the cache emptied, the reserved
    memory is back within 1% of what it was."""
    import gc

    def one_run():
        ex, buf, _, _ = path_executor(cuda, "fused_otf")
        out = ex.run(buf)
        torch.cuda.synchronize()
        return out.sum().item()

    one_run()                 # the capture stream's cuBLAS workspace
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    one_run()
    gc.collect()
    torch.cuda.empty_cache()
    assert abs(torch.cuda.memory_reserved() - base) <= 0.01 * base


@pytest.mark.parametrize("orientation,key", [("fused_otf", "k1"),
                                             ("fused", "k2")])
def test_calibration_times_the_work_around_the_kernel_alone(cuda,
                                                            orientation, key):
    """The calibration's ``around_ms`` is a one-level graph's replay with
    the kernel's node left out: the kernel is launched only by the
    warm-up and the timed steps, and no graph is kept."""
    from tfhe_fbs_map_tpu_torch.optimizer import calibrate
    ex = calibrate._executor(TEST_PARAMS, orientation, cuda)
    before = fbr.LAUNCHES[key]
    pt = calibrate.time_point(ex, 16, 8, reps=2)
    assert fbr.LAUNCHES[key] - before == 1 + 2 * pt["iters"]
    assert len(pt["all_around_ms"]) == 2
    assert pt["around_ms"] > 0 and pt["kernel_ms"] > 0
    assert ex._graphs == {}


# K1 below N=256: its small-N kernel at N = 32, 64 and 128, and at the
# widest served shapes (b = 1, l = 31, the most columns), where a step runs
# one digit pass a component
SMALL_N = [(N, k, l) for N in (32, 64, 128) for k in (1, 2) for l in (2, 3)]
WIDEST = [(N, 512 // N - 1, 31) for N in (32, 64, 128)]


def small_shape(N, k, l):
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
    return TFHEParams(p=4, lwe_dim=8, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=8 if l == 2 else 7 if l == 3 else 1,
                      ksk_level=1, ksk_base_log=2, lwe_noise_std=0.0,
                      glwe_noise_std=0.0)


@pytest.mark.parametrize("N,k,l", SMALL_N + WIDEST)
def test_small_n_k1_equals_plain(cuda, N, k, l):
    """The small-N kernel, bitwise against K1's plain version on the card,
    at 4 and 3 limbs and a ragged and a full batch, one launch counted as
    K1's each; on the largest cluster it is built for, one digit pass a
    step at l ≤ 3 and one a component at l = 31."""
    params = small_shape(N, k, l)
    assert fbr.unsupported(params, otf=True) is None
    for batch in (21, 512):
        for limbs in (4, 3):
            b_init, a_t, tvs, keys = operands(params, batch, True, seed=N)
            keys = keys[:, (4 - limbs) * (k + 1):].contiguous()
            dev = [x.to(cuda) for x in (b_init, a_t, tvs, keys)]
            plan = fbr.k1_device_plan(batch, params, cuda, limbs)
            assert plan.cluster == fbr.k1s_clusters(params, limbs)[0] > 1
            assert plan.passes == (1 if l <= 3 else k + 1)
            plain = fbr.blind_rotate_k1_plain(*dev, params)
            before = fbr.LAUNCHES["k1"]
            got = fbr.blind_rotate_k1(*dev, params)
            torch.cuda.synchronize()
            assert fbr.LAUNCHES["k1"] == before + 1
            assert torch.equal(got, plain), (batch, limbs)


def test_small_n_layout_and_plan_on_the_card(cuda):
    """The small-N kernel's shared memory, as it sizes it, is the host's
    copy of its layout (``k1_small_smem``, which chose the plan's digit
    passes) and fits a CTA at the widest served shapes (b = 1, so l = 31,
    and the most columns) and at the JAX package's small families, for
    every cluster it is built for; the card runs as many clusters of the
    default plan as the calibration's resident table says where it has the
    plan, and of every plan at least the fewest that table holds for a
    small-N plan of its cluster size (one CTA an SM: more fit where shared
    memory is small); every cluster the kernel is built for launches
    bitwise; the card's plan is the one the runtime model prices."""
    from tfhe_fbs_map_tpu_torch import bench, bench_multichip
    from tfhe_fbs_map_tpu_torch.optimizer import runtime_model
    from tfhe_fbs_map_tpu_torch.optimizer.optimizer import calibration
    from tfhe_fbs_map_tpu_torch.parallel.dryrun import DRYRUN_PARAMS
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    table = calibration()["resident"]
    widest = [small_shape(*s) for s in WIDEST]
    jax = [DRYRUN_PARAMS, bench.QUICK_PARAMS, bench_multichip.QUICK_PARAMS,
           STAGED_PRESETS["staged_test"].fam2]
    floor = {}
    for key, clusters in table.items():
        # the small-N plans' entries (the small-tile plan's at N = 512 have
        # more shared memory and warps a CTA)
        parts = key.split("/")
        if parts[0] == "k1s" and int(parts[-1].split("x")[1]) < fbr.K1_SLICE:
            c = int(parts[2])
            floor[c] = min(floor.get(c, clusters), clusters)
    calibrated = 0
    for params in jax + widest:
        assert fbr.unsupported(params, otf=True) is None
        for limbs in (4, 3):
            plan = fbr.k1_device_plan(512, params, cuda, limbs)
            assert isinstance(plan, fbr.K1SmallPlan)
            _, clusters = fbr.k1_small_layout(plan, params, limbs)
            key = runtime_model.resident_key("fused_otf", limbs, plan,
                                             params)
            if key in table:
                assert clusters == table[key], key
                calibrated += 1
            assert clusters >= floor.get(plan.cluster, 1), plan
            for c in fbr.k1s_clusters(params, limbs):
                other = fbr.k1_small_plan(params, limbs, cluster=c)
                smem, clusters = fbr.k1_small_layout(other, params, limbs)
                assert smem == fbr.k1_small_smem(params, limbs, c,
                                                 other.passes)
                assert smem <= fbr.SMEM_MAX
                assert clusters >= floor.get(c, 1), other
        assert runtime_model.launch_plan(params, 512, "fused_otf")[0] \
            == fbr.k1_device_plan(512, params, cuda)
    assert calibrated >= 4
    params = DRYRUN_PARAMS
    b_init, a_t, tvs, keys = operands(params, 40, True, seed=5)
    dev = [x.to(cuda) for x in (b_init, a_t, tvs, keys)]
    plain = fbr.blind_rotate_k1_plain(*dev, params)
    for c in fbr.k1s_clusters(params):
        got = fbr.blind_rotate_k1(*dev, params, cluster=c)
        torch.cuda.synchronize()
        assert torch.equal(got, plain), c


# K1's small-tile plan at N = 512: every family the calibration times it
# at (calibrate.wide_families) and the shapes it takes by their fit
# (calibrate.fit_families), a few steps, at the launch sizes of one to 64
# evaluations
WIDE_BATCHES = (1, 4, 21, 64, 128, 256, 512)


def wide_families():
    from tfhe_fbs_map_tpu_torch.optimizer import calibrate
    return {name: params for name, (params, _) in
            {**calibrate.wide_families(),
             **calibrate.fit_families()}.items()}


@pytest.mark.parametrize("name", ["aes128_p4", "anchor", "p8",
                                  "kreyvium_p10_staged.fam2",
                                  "p32_staged.fam2", "k=2 N=512 l=1",
                                  "k=2 N=512 l=3"])
def test_small_tile_k1_equals_plain(cuda, name):
    """K1 at N = 512 on the launch the cost model chooses (the small-tile
    plan where the calibration prices it lower, else the ring's) and on the
    small-tile plan of every tile and cluster it is built for, bitwise
    against the plain version at 4 and 3 limbs; one launch counted as K1's
    each, and under ``K1_KERNELS`` as the kernel's that ran it."""
    import dataclasses
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import launch_choice
    full = wide_families()[name]
    params = dataclasses.replace(full, lwe_dim=5)
    for limbs in (4, 3):
        for batch in WIDE_BATCHES:
            b_init, a_t, tvs, keys = operands(params, batch, True,
                                              seed=batch + limbs)
            keys = keys[:, (4 - limbs) * (params.glwe_dim + 1):] \
                .contiguous()
            dev = [x.to(cuda) for x in (b_init, a_t, tvs, keys)]
            plain = fbr.blind_rotate_k1_plain(*dev, params)
            # the full family's launch (its calibrated entries) on the
            # short one's steps
            chosen = launch_choice(full, batch, 1, "fused_otf", limbs)
            routes = [(chosen.route, *(chosen.tile or (None, None)))] + [
                ("k1s", t, c) for t in fbr.K1S_WIDE_TILES
                for c in fbr.k1s_clusters(params, limbs, t)
                if batch in (21, 128)]
            for route, t, c in routes:
                before = fbr.LAUNCHES["k1"]
                kernels = dict(fbr.K1_KERNELS)
                got = fbr.blind_rotate_k1(*dev, params, batch_tile=t,
                                          cluster=c, route=route)
                torch.cuda.synchronize()
                assert fbr.LAUNCHES["k1"] == before + 1
                ran = ("k1s_kernel_wide" if route == "k1s" else "k1_kernel")
                assert {k: fbr.K1_KERNELS[k] - n
                        for k, n in kernels.items()} == {
                    k: int(k == ran) for k in kernels}
                assert torch.equal(got, plain), (batch, limbs, t, c)


@pytest.mark.parametrize("name,v,real,plans", [
    ("aes128_p4", 1, 112, ((16, 16), (64, 12))),
    ("kreyvium_p10_staged.fam1", 8, 369, (None, None))])
def test_packed_launch_equals_the_bucketed_one(cuda, name, v, real, plans):
    """A level's launch of its real rows packed to whole tiles
    (``runtime_model.launch_rows``) gives each of them, bitwise, what the
    launch of the plan's power-of-two bucket gives it, each launch on the
    plan its own count takes: AES-128's family at 112 rows of one
    evaluation (tiles of 16 on 16 CTAs, one wave, against 128 on the
    ring's tiles of 64 on clusters of 12, which its calibrated price
    takes for one launch of 128) and Kreyvium's fam1 at 2,952 rows of
    eight (the ring kernel, 3,008 launched against 4,096)."""
    import dataclasses
    from tfhe_fbs_map_tpu_torch.optimizer import calibrate
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import (
        bucket, launch_choice, launch_rows)
    full = calibrate.families()[name][0]
    params = dataclasses.replace(full, lwe_dim=5)
    whole = v * bucket(real)
    packed = launch_rows(full, real, v, "fused_otf")
    assert v * real <= packed < whole
    dev = [x.to(cuda) for x in operands(params, whole, True, seed=real)]
    got = {}
    for rows, plan in zip((packed, whole), plans):
        # the full family's launch (its calibrated entries) on the short
        # one's steps
        c = launch_choice(full, rows, 1, "fused_otf")
        cb, cluster = c.tile or (None, None)
        small = fbr.k1_device_plan(rows, params, cuda, 4, cb, cluster,
                                   route=c.route)
        assert plan is None or (small.cb, small.cluster) == plan
        got[rows] = fbr.blind_rotate_k1(
            dev[0][:rows].contiguous(), dev[1][:, :rows].contiguous(),
            dev[2][:rows].contiguous(), dev[3], params, cb, cluster,
            route=c.route)
    torch.cuda.synchronize()
    assert torch.equal(got[packed], got[whole][:, :packed])


# K1's ring kernel at the cells' launches, full length: AES-128's family at
# 1,024 and 520 rows, Kreyvium's fam1 at 3,200 and at 2,280 (its smallest
# packed launch, a ragged last tile of 40)
RING_LAUNCHES = [("aes128_p4", 1024), ("aes128_p4", 520),
                 ("kreyvium_p10_staged.fam1", 3200),
                 ("kreyvium_p10_staged.fam1", 2280)]


@pytest.mark.parametrize("name,batch", RING_LAUNCHES)
def test_ring_kernel_reads_the_table_bitwise(cuda, name, batch):
    """K1's ring kernel, its H blocks copied from the keys' table, bitwise
    against the plain version at full length (operands drawn on the card),
    twice on one table: the keys' table is built once."""
    from tfhe_fbs_map_tpu_torch.runtime.bisect import operands, shapes
    params = shapes()[name]
    dev = operands(params, batch, seed=batch)
    assert isinstance(fbr.k1_device_plan(batch, params, cuda, route="k1"),
                      fbr.K1Plan)
    before, kept = dict(fbr.HANKEL), []

    def hankel():
        if not kept:
            kept.append(fbr.hankel_table(dev[3]))
        return kept[0]
    got = [fbr.blind_rotate_k1(*dev, params, route="k1", hankel=hankel)
           for _ in range(2)]
    plain = fbr.blind_rotate_k1_plain(*dev, params)
    assert fbr.HANKEL["tables"] == before["tables"] + 1
    assert torch.equal(got[0], plain) and torch.equal(got[1], plain)


def _short(name_or_shape, steps):
    """A ring family cut to ``steps`` CMux steps: a preset or staged
    family by name (``runtime.bisect.shapes``), or (k, N, l, b)."""
    import dataclasses

    from tfhe_fbs_map_tpu_torch.runtime.bisect import shapes
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
    if isinstance(name_or_shape, str):
        return dataclasses.replace(shapes()[name_or_shape], lwe_dim=steps)
    k, N, l, b = name_or_shape
    return TFHEParams(p=4, lwe_dim=steps, glwe_dim=k, poly_size=N,
                      bsk_level=l, bsk_base_log=b, ksk_level=1,
                      ksk_base_log=2, lwe_noise_std=0.0, glwe_noise_std=0.0)


# The paired ring kernel (two tiles a cluster in turns) at short n: the
# cells' launches (AES-128 at 1,024 and 520, fam1 at 3,200), odd tile counts
# (a lone last tile), and N = 2048 and 4096 at 4 and 3 limbs, which no cell
# runs (K1_MAX_N)
PAIR_LAUNCHES = [("aes128_p4", 16, 1024, 4), ("aes128_p4", 16, 520, 4),
                 ("aes128_p4", 16, 150, 4), ("aes128_p4", 16, 65, 3),
                 ("kreyvium_p10_staged.fam1", 8, 3200, 4),
                 ((1, 2048, 3, 7), 6, 700, 4), ((1, 2048, 3, 7), 6, 300, 3),
                 ((1, 4096, 2, 8), 4, 520, 4), ((1, 4096, 2, 8), 4, 130, 3)]


@pytest.mark.parametrize("shape,steps,batch,limbs", PAIR_LAUNCHES)
def test_paired_kernel_equals_plain_every_plan(cuda, shape, steps, batch,
                                               limbs):
    """Every plan of the paired ring kernel (every tile, width and cluster
    it is built for, two tiles a cluster, the last alone where their
    count is odd) bitwise against K1's plain version."""
    from tfhe_fbs_map_tpu_torch.runtime.bisect import operands
    params = _short(shape, steps)
    b_init, a_t, tvs, keys = operands(params, batch, seed=batch + steps)
    keys = keys[:, :limbs * (params.glwe_dim + 1)].contiguous()
    table = fbr.hankel_table(keys)
    plain = fbr.blind_rotate_k1_plain(b_init, a_t, tvs, keys, params)
    for cb in fbr.K1_TILES:
        for nw in fbr.K1_WIDTHS:
            if not fbr.k1_fits(cb, nw, limbs):
                continue
            for c in fbr.k1_clusters(params, nw):
                got = fbr.blind_rotate_k1(b_init, a_t, tvs, keys, params,
                                          cb, c, nw, "k1", lambda: table,
                                          pair=2)
                assert torch.equal(got, plain), (cb, c, nw)


# Both ring kernels' ACC epilogue, the reduce-add of staged boxes, at short
# n: AES-128 at 65 (a pair's lone last tile, rows past the batch), 520 and
# 1,024, fam1 at 3,200, tiles of 128 (two 64-row boxes a warpgroup, staged
# in two parts; at 2 limbs also nw = 64) and N = 2,048 at 3 limbs
EPILOGUE_LAUNCHES = [("aes128_p4", 16, 65, 4, None),
                     ("aes128_p4", 16, 520, 4, None),
                     ("aes128_p4", 16, 1024, 4, None),
                     ("kreyvium_p10_staged.fam1", 8, 3200, 4, None),
                     ("aes128_p4", 16, 520, 4, (128, 32)),
                     ("aes128_p4", 8, 300, 2, (128, 64)),
                     ((1, 2048, 3, 7), 6, 700, 3, None)]


@pytest.mark.parametrize("shape,steps,batch,limbs,tile", EPILOGUE_LAUNCHES)
def test_ring_kernels_reduce_add_their_epilogue(cuda, shape, steps, batch,
                                                limbs, tile):
    """One tile a cluster and two, each at the plan the card picks for it
    (or at the tile and width given), bitwise against K1's plain version;
    each launch counted once under ``K1_EPILOGUES["reduce"]``."""
    from tfhe_fbs_map_tpu_torch.runtime.bisect import operands
    params = _short(shape, steps)
    b_init, a_t, tvs, keys = operands(params, batch, seed=batch + limbs)
    keys = keys[:, :limbs * (params.glwe_dim + 1)].contiguous()
    table = fbr.hankel_table(keys)
    plain = fbr.blind_rotate_k1_plain(b_init, a_t, tvs, keys, params)
    cb, nw = tile or (None, None)
    for pair in fbr.K1_PAIRS:
        before = dict(fbr.K1_EPILOGUES)
        got = fbr.blind_rotate_k1(b_init, a_t, tvs, keys, params, cb, None,
                                  nw, "k1", lambda: table, pair=pair)
        torch.cuda.synchronize()
        assert {k: fbr.K1_EPILOGUES[k] - n for k, n in before.items()} \
            == {"reduce": 1, "load_store": 0}
        assert torch.equal(got, plain), pair


@pytest.mark.parametrize("shape", [(1, 256, 3, 6), (2, 512, 2, 8),
                                   (1, 1024, 4, 5), (1, 2048, 3, 7),
                                   (1, 4096, 2, 8)])
def test_ring_plan_picked_equals_plain(cuda, shape):
    """The ring plan the card picks (one tile a cluster or two) at each
    launch size from one tile to past a wave of pairs, bitwise against
    K1's plain version at short n."""
    from tfhe_fbs_map_tpu_torch.runtime.bisect import operands
    params = _short(shape, 4)
    for batch in (64, 520, 1024, 2048, 3200):
        dev = operands(params, batch, seed=batch)
        plan = fbr.k1_device_plan(batch, params, cuda, route="k1")
        got = fbr.blind_rotate_k1(*dev, params, route="k1")
        assert torch.equal(got, fbr.blind_rotate_k1_plain(*dev, params)), \
            (batch, plan)


def test_a_key_off_the_ring_builds_no_table(cuda):
    """A key whose launches all take the small-tile plan builds no table
    (``HANKEL`` unchanged, none kept by its ``FastKeys``); its first ring
    launch builds one, which its later ring launches read."""
    import dataclasses
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import FastKeys
    from tfhe_fbs_map_tpu_torch.runtime.bisect import operands, shapes
    params = dataclasses.replace(shapes()["aes128_p4"], lwe_dim=5)
    dev = operands(params, 64, seed=3)
    fast = FastKeys(params, dev[3], torch.zeros(8, 8, dtype=torch.int8,
                                                device=cuda), "fused_otf")
    plain = fbr.blind_rotate_k1_plain(*dev, params)
    cluster = fbr.k1s_clusters(params, 4, 16)[0]
    before = dict(fbr.HANKEL)
    for _ in range(2):
        got = fbr.blind_rotate_fused(*dev, params, 16, None, "k1s", cluster,
                                     fast.hankel)
        assert torch.equal(got, plain)
    assert fbr.HANKEL == before and fast._hankel is None
    for _ in range(2):
        got = fbr.blind_rotate_fused(*dev, params, None, None, "k1", None,
                                     fast.hankel)
        assert torch.equal(got, plain)
    assert fbr.HANKEL == {"tables": before["tables"] + 1,
                          "bytes": before["bytes"] + 16 * dev[3].numel()}
    assert fast._hankel is not None


def test_small_tile_layout_on_the_card(cuda):
    """The small-tile plan's shared memory, as the kernel sizes it, is the
    host's copy of its layout (``k1_small_smem``) at every family, tile and
    cluster it is built for, at 4 and 3 limbs; the card runs as many
    clusters of each as the calibration's resident table says; the card's
    plan at every launch size is the runtime model's."""
    from tfhe_fbs_map_tpu_torch.optimizer import runtime_model
    from tfhe_fbs_map_tpu_torch.optimizer.optimizer import calibration
    table = calibration()["resident"]
    for params in wide_families().values():
        for limbs in (4, 3):
            for t in fbr.K1S_WIDE_TILES:
                for c in fbr.k1s_clusters(params, limbs, t):
                    plan = fbr.k1_wide_plan(1, params, 132, limbs, c, cb=t)
                    smem, clusters = fbr.k1_small_layout(plan, params, limbs)
                    assert smem == fbr.k1_small_smem(
                        params, limbs, c, plan.passes, t) <= fbr.SMEM_MAX
                    key = runtime_model.resident_key("fused_otf", limbs,
                                                     plan, params)
                    assert clusters == table[key], key
            for batch in WIDE_BATCHES:
                c = runtime_model.launch_choice(params, batch, 1,
                                                "fused_otf", limbs)
                assert runtime_model.launch_plan(
                    params, batch, "fused_otf", limbs)[0] \
                    == fbr.k1_device_plan(batch, params, cuda, limbs,
                                          *(c.tile or (None, None)),
                                          route=c.route)


@pytest.mark.parametrize("argv,launches", [
    (["--quick", "--orientation", "fused_otf"], 9),
    (["--preset", "p32", "--quick"], 18),
])
def test_quick_bench_on_the_card(cuda, argv, launches, capsys):
    """``bench --quick`` runs on the card by default, its N=128 families
    through K1's small-N kernel: errors 0, one K1 launch a family call."""
    from tfhe_fbs_map_tpu_torch import bench
    before = dict(fbr.LAUNCHES)
    assert bench.main(argv) == 0
    torch.cuda.synchronize()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == 0
    assert out["device"] == torch.cuda.get_device_name(0)
    assert {k: fbr.LAUNCHES[k] - before[k] for k in before} \
        == {"k1": launches, "k2": 0}


def test_quick_multichip_and_dryrun_on_the_card(cuda, capsys):
    """``bench_multichip --quick`` (N=128) through K1, 3 launches a
    position (one checked and 2 timed calls under ``--quick``), and the dry
    run at the JAX dry run's families (N=64, 256 and
    128) on two shards of the card, bit-exact."""
    from tfhe_fbs_map_tpu_torch import bench_multichip
    from tfhe_fbs_map_tpu_torch.parallel import dryrun
    before = fbr.LAUNCHES["k1"]
    assert bench_multichip.main(["--quick", "--dp", "2"]) == 0
    torch.cuda.synchronize()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["errors"] == 0 and out["dp"] == 2
    assert fbr.LAUNCHES["k1"] - before == 2 * (1 + 2)
    assert dryrun.main(["--dp", "2"]) == 0
    assert all(line.endswith("bit_exact=True")
               for line in capsys.readouterr().out.strip().splitlines())


# ------------------------------------------------ the matmul orientation

def aes_shape(lwe_dim: int = 8):
    """The aes128_p4 family (k=2, N=512, l=2, b=8) with n cut."""
    from dataclasses import replace
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS
    return replace(PRESETS["aes128_p4"][0], lwe_dim=lwe_dim)


def identity_batch(keys, batch, seed):
    from tfhe_fbs_map_tpu_torch.tfhe.encrypt import decrypt_values
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 3, batch)
    cts = encrypt_values(keys, values, rng)
    tv, post = build_test_vector([1, 0, 1], keys.params)
    tvs = torch.from_numpy(np.tile(tv, (batch, 1))).to(keys.device)
    posts = torch.full((batch,), int(np.int64(post).astype(np.uint32)
                                     .astype(np.int32)),
                       dtype=torch.int32, device=keys.device)
    return values, (cts, tvs, posts), decrypt_values


@pytest.mark.parametrize("limbs", [4, 3])
def test_matmul_fbs_equals_k2(cuda, limbs):
    """The matmul orientation on the card (``torch._int_mm`` a step over
    K2's key matrices) is bitwise K2's FBS, at 4 and at 3 key limbs, and
    launches no fused kernel."""
    keys = generate_keys(aes_shape(), seed=6, device=cuda)
    _, args, _ = identity_batch(keys, 96, 7)
    k2 = functional_bootstrap_fast(prepare_fast_keys(keys, "fused", limbs),
                                   *args)
    mm = prepare_fast_keys(keys, "matmul", limbs)
    before = dict(fbr.LAUNCHES)
    got = functional_bootstrap_fast(mm, *args)
    torch.cuda.synchronize()
    assert fbr.LAUNCHES == before
    assert torch.equal(got, k2)


def test_matmul_launch_copies_no_key_slice(cuda, monkeypatch):
    """Every step hands ``torch._int_mm`` its [D, T] key matrix as the
    transposed view of the key tensor, and cuBLAS takes it as it lies: a
    launch's peak memory stays under half of one step's matrix (18.9 MB
    here) above what it started from, where one copy of a slice would add
    all of it."""
    keys = generate_keys(aes_shape(4), seed=6, device=cuda)
    _, args, _ = identity_batch(keys, 24, 8)
    fast = prepare_fast_keys(keys, "matmul")
    kern = fast.bsk_kernels
    functional_bootstrap_fast(fast, *args)         # cuBLAS's workspace
    torch.cuda.synchronize()
    operands = []
    inner = torch._int_mm

    def spy(a, b):
        operands.append(b)
        return inner(a, b)
    monkeypatch.setattr(torch, "_int_mm", spy)
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    functional_bootstrap_fast(fast, *args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda) - base
    slice_bytes = kern[0].numel()
    assert rise < slice_bytes // 2, (rise, slice_bytes)
    steps = [b for b in operands if b.shape == kern[0].t().shape]
    assert len(steps) == kern.shape[0]
    for i, b in enumerate(steps):
        assert b.data_ptr() == kern[i].data_ptr()
        assert b.stride() == (1, b.shape[0])


@pytest.mark.parametrize("dp", [1, 2])
def test_tp2_on_one_card(cuda, dp):
    """tp=2 as two positions of one card: the sharded matmul FBS at (dp, 2)
    equals the one-device FBS at every position, its launch waits on the
    host nowhere, and the mesh executor at (1, 2) equals one device's."""
    from tfhe_fbs_map_tpu_torch.parallel import (make_mesh, shard_batch,
                                                 sharded_bootstrap)
    keys = generate_keys(aes_shape(), seed=6, device=cuda)
    _, args, _ = identity_batch(keys, 64, 9)
    fast = prepare_fast_keys(keys, "matmul")
    want = functional_bootstrap_fast(fast, *args)
    mesh = make_mesh([cuda] * (2 * dp), tp=2)
    fn = sharded_bootstrap(mesh, fast)
    shards = [shard_batch(mesh, x) for x in args]
    fn(*shards)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*shards)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for group in mesh.groups(got):
        assert torch.equal(group[0], group[1])
    assert torch.equal(torch.cat(mesh.leaders(got)), want)
    if dp == 1:
        from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
        ex, buf, _, _ = path_executor(cuda, "matmul")
        one = ex.run(buf)
        two = CircuitExecutor(ex.prog, ex.keys, fast_keys=ex.fast_keys,
                              mesh=mesh)
        assert two.capture(shard_batch(mesh, buf, axis=1)) == 0
        got = two.run(shard_batch(mesh, buf, axis=1))
        assert torch.equal(got[0], one) and torch.equal(got[1], one)


# ------------------------------------------------ the conv orientations

CONV = ["keys_rhs", "keys_lhs", "keys_lhs_bf16"]


def conv_shapes():
    """The conv anchor (k=2, N=512, l=3, b=7) and Kreyvium-1152's fam1
    (k=1, N=1024, l=4, b=5), n cut to 8."""
    from dataclasses import replace
    from tfhe_fbs_map_tpu_torch.bench import CONV_ANCHOR
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS
    fam1 = STAGED_PRESETS["kreyvium_p10_staged"].fam1
    return [replace(p, lwe_dim=8) for p in (CONV_ANCHOR, fam1)]


@pytest.mark.parametrize("orientation", CONV)
def test_conv_fbs_equals_k1(cuda, orientation):
    """Each conv orientation on the card (one library product a step) is
    bitwise K1's FBS, and K2's, at both shapes, and launches no fused
    kernel."""
    for params in conv_shapes():
        keys = generate_keys(params, seed=6, device=cuda)
        _, args, _ = identity_batch(keys, 96, 7)
        want = functional_bootstrap_fast(
            prepare_fast_keys(keys, "fused_otf"), *args)
        k2 = functional_bootstrap_fast(prepare_fast_keys(keys, "fused"),
                                       *args)
        assert torch.equal(k2, want)
        conv = prepare_fast_keys(keys, orientation)
        before = dict(fbr.LAUNCHES)
        got = functional_bootstrap_fast(conv, *args)
        torch.cuda.synchronize()
        assert fbr.LAUNCHES == before
        assert torch.equal(got, want), params


@pytest.mark.parametrize("orientation", CONV)
def test_conv_launch_builds_one_step_matrix(cuda, orientation):
    """A launch's peak memory rises by about one step's key matrix (28.3
    MB int8 at the conv anchor, twice that for keys_rhs's 2N contraction
    and the bf16 layout), never by n of them."""
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import conv_step_matrix
    params = conv_shapes()[0]
    keys = generate_keys(params, seed=6, device=cuda)
    _, args, _ = identity_batch(keys, 24, 8)
    fast = prepare_fast_keys(keys, orientation)
    functional_bootstrap_fast(fast, *args)          # cuBLAS's workspace
    torch.cuda.synchronize()
    step = conv_step_matrix(fast.bsk_kernels[0], params, orientation)
    step_bytes = step.numel() * step.element_size()
    del step
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    functional_bootstrap_fast(fast, *args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(cuda) - base
    assert step_bytes <= rise < 2 * step_bytes, (rise, step_bytes)
