"""A level's launch of its real bootstraps, packed over the V evaluations
and padded only to whole tiles of the kernel that serves it
(``runtime_model.launch_rows``, ``CircuitExecutor.launch_layout``), against
the JAX executor's power-of-two buckets: the wire buffer, dummy row
included, bitwise JAX's after every level (native at V = 1, 3, 8, staged
with split rows, dp = 2, a checkpoint resumed across a packed level); the
family calls' and the launch record's counts at AES-128's and Kreyvium's
programs; and the small-tile plan picked and priced by waves at the
packed counts (``calibration_h100.json``).

On the CPU no kernel has tiles, so a level launches its real rows alone;
``tiles`` stands in for a card's kernel, whose tiles leave some padding.
"""

import math
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfhe_fbs_map_tpu.tfhe as J
import tfhe_fbs_map_tpu.tfhe.staged as JS
from tfhe_fbs_map_tpu.frontend import HeuristicMapper
from tfhe_fbs_map_tpu.frontend.circuits import build_bench
from tfhe_fbs_map_tpu.frontend.lut_program import LutProgram
from tfhe_fbs_map_tpu.runtime import executor as jexec
import tfhe_fbs_map_tpu_torch.tfhe as T
from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.optimizer import runtime_model as RM
from tfhe_fbs_map_tpu_torch.optimizer.optimizer import calibration
from tfhe_fbs_map_tpu_torch.parallel.mesh import make_mesh
from tfhe_fbs_map_tpu_torch.runtime import executor as texec
from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, STAGED_PRESETS
from tfhe_fbs_map_tpu_torch.tfhe.staged import StagedKeys
from tfhe_fbs_map_tpu_torch.utils import profiling
from test_staged_executor import P32_F1, P32_F2
from test_torch_staged import carried as carried_staged
from test_torch_staged_executor import jax_staged_executor, jexec_arrays

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
AES_LBF = ROOT / "bench_h100" / "programs" / "aes_128_4_search.lbf"
KREYVIUM_LBF = ROOT / "bench_h100" / "programs" \
    / "kreyvium_stream_v1_10_search.lbf"


def tiles(monkeypatch, tile):
    """Every launch of the executor served by tiles of ``tile``
    ciphertexts, as a card's kernel serves it (None: the CPU's layout)."""
    if tile is None:
        return

    def rows(params, real, v, orientation, bsk_limbs=4, route=None):
        step = tile // math.gcd(tile, v)
        return v * min(RM.bucket(real), -(-real // step) * step)
    monkeypatch.setattr(RM, "launch_rows", rows)


def carried(jk):
    return T.keys_from_numpy(T.TFHEParams(**vars(jk.params)),
                             np.asarray(jk.lwe_key), np.asarray(jk.glwe_key),
                             np.asarray(jk.bsk), np.asarray(jk.ksk),
                             device="cpu")


@pytest.fixture(scope="module")
def native():
    """AES-128's S-box mapped at p=4 (11 levels of 2 to 6 bootstraps, most
    of them short of their bucket) and the JAX keys with the port's copy."""
    prog = HeuristicMapper(cone_merger="search", fbs_size=4) \
        .map(build_bench("aes_sbox"))
    prog.remove_dangling_nodes()
    jk = J.generate_keys(J.TEST_PARAMS, seed=5)
    return prog, jk, carried(jk)


def inputs(prog, v, seed=0):
    rng = np.random.default_rng(seed)
    return {n.name: rng.integers(0, 2, v)
            for n in prog.nodes if n.kind == "input"}


def plan_arrays(plan):
    return (plan.wire_idx, plan.coefs, plan.consts, plan.test_polys,
            plan.posts, plan.out_rows)


@pytest.mark.parametrize("v,tile", [(1, None), (1, 2), (3, None), (3, 6),
                                    (8, None), (8, 16)])
def test_native_buffer_equals_jax_after_every_level(native, monkeypatch, v,
                                                    tile):
    """Each level launches V·r rows, r its real bootstraps rounded up to
    whole tiles and at most its bucket, and the buffer after it, dummy row
    included, is bitwise the JAX executor's, which launches the bucket."""
    tiles(monkeypatch, tile)
    prog, jk, tk = native
    jex = jexec.CircuitExecutor(prog, jk)
    tex = texec.CircuitExecutor(prog, tk)
    vals = inputs(prog, v)
    jbuf = jex.encrypt_inputs(vals, np.random.default_rng(1))
    tbuf = tex.encrypt_inputs(vals, np.random.default_rng(1))
    short = 0
    for lv, plan in enumerate(jex.levels):
        (fam, launched, real), = tex.family_calls(lv, v)
        nb = plan.wire_idx.shape[0]
        step = 1 if tile is None else tile // math.gcd(tile, v)
        assert launched == v * min(nb, -(-(real // v) // step) * step)
        short += launched < v * nb
        jbuf = jexec._level_step(jk, None, jbuf,
                                 *map(jnp.asarray, plan_arrays(plan)))
        tbuf = tex.step(tbuf, lv)
        assert np.array_equal(np.asarray(jbuf), tbuf.numpy()), lv
    assert short >= 3
    want, got = jex.decrypt_outputs(jbuf), tex.decrypt_outputs(tbuf)
    oracle = prog.eval(vals)
    for k in oracle:
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(got[k], np.asarray(oracle[k])), k


def split_program(rng) -> LutProgram:
    """A p=32 program of two levels with every staged route: three split
    nodes, two fam1 singles and one fam2 single, then two splits and a fam1
    single on their outputs."""
    prog = LutProgram()
    w = [prog.input(f"w{i}") for i in range(5)]

    def tbl(n):
        t = rng.integers(0, 2, n)
        t[rng.integers(0, n)] = 0          # tables must contain a 0
        return t.tolist()

    first = [prog.bootstrap(prog.linear([1, 2, 4, 8, 16], w[i:] + w[:i], 0),
                            tbl(32)) for i in range(3)]
    first += [prog.bootstrap(prog.linear([1, 2, 4, 8], w[i:i + 4], 0),
                             tbl(16)) for i in range(2)]
    first.append(prog.bootstrap(prog.linear([1, 2], w[:2], 0), tbl(4)))
    second = [prog.bootstrap(prog.linear([1, 2, 4, 8, 16],
                                         first[i:i + 5], 0), tbl(32))
              for i in range(2)]
    second.append(prog.bootstrap(prog.linear([1, 2, 4, 8], first[2:], 0),
                                 tbl(16)))
    for i, node in enumerate(first + second):
        prog.output(f"o{i}", node)
    return prog


@pytest.mark.parametrize("v,tile", [(2, None), (2, 4), (3, None), (3, 6)])
def test_staged_buffer_equals_jax_after_every_level(monkeypatch, v, tile):
    """The staged levels' fam1 and fam2 calls packed the same way, split
    rows first: the buffer after every level, dummy row included, is the
    JAX executor's (where the plan pads a call and its launch does not, the
    dummy row is cleared as the plan's padding would leave it)."""
    tiles(monkeypatch, tile)
    prog = split_program(np.random.default_rng(3))
    jsk = JS.generate_staged_keys(32, P32_F1, P32_F2, seed=13)
    jex = jax_staged_executor(prog, 32, jsk)
    tex = texec.CircuitExecutor(prog, carried_staged(jsk))
    assert [lv.n_splits for lv in tex.levels] == [3, 2]
    vals = inputs(prog, v)
    jbuf = jex.encrypt_inputs(vals, np.random.default_rng(1))
    tbuf = tex.encrypt_inputs(vals, np.random.default_rng(1))
    short = 0
    for lv, plan in enumerate(jex.levels):
        calls = tex.family_calls(lv, v)
        nbs = (plan.wire_idx1.shape[0], plan.wire_idx2.shape[0])
        short += sum(n < v * nb for (_, n, _), nb in zip(calls, nbs))
        jbuf = jexec._staged_level_step(
            jsk.keys1, jsk.keys2, None, None, plan.n_splits, jbuf,
            *map(jnp.asarray, jexec_arrays(plan)))
        tbuf = tex.step(tbuf, lv)
        assert np.array_equal(np.asarray(jbuf), tbuf.numpy()), lv
    assert short >= 1
    want, got = jex.decrypt_outputs(jbuf), tex.decrypt_outputs(tbuf)
    oracle = prog.eval(vals)
    for k in oracle:
        assert np.array_equal(want[k], got[k]), k
        assert np.array_equal(got[k] % 64, np.asarray(oracle[k]) % 64), k


@pytest.mark.parametrize("tile", [None, 4])
def test_dp2_shards_equal_jax_after_every_level(native, monkeypatch, tile):
    """At dp = 2 each shard packs its own V/2 evaluations: the shards,
    joined, are JAX's buffer after every level."""
    tiles(monkeypatch, tile)
    prog, jk, tk = native
    jex = jexec.CircuitExecutor(prog, jk)
    tex = texec.CircuitExecutor(prog, tk, mesh=make_mesh(["cpu", "cpu"]))
    vals = inputs(prog, 6)
    jbuf = jex.encrypt_inputs(vals, np.random.default_rng(1))
    shards = tex.encrypt_inputs(vals, np.random.default_rng(1))
    assert [s.shape[1] for s in shards] == [3, 3]
    for lv, plan in enumerate(jex.levels):
        jbuf = jexec._level_step(jk, None, jbuf,
                                 *map(jnp.asarray, plan_arrays(plan)))
        shards = tex._step_all(shards, lv)
        assert np.array_equal(np.asarray(jbuf),
                              torch.cat(shards, dim=1).numpy()), lv


def test_checkpoint_resumes_across_a_packed_level(native, monkeypatch,
                                                  tmp_path):
    """A JAX snapshot taken after level 0 resumes in the port at level 1, a
    launch shorter than its bucket, and the run ends bitwise JAX's; so does
    the port's own snapshot, written every level."""
    tiles(monkeypatch, 2)
    prog, jk, tk = native
    jex = jexec.CircuitExecutor(prog, jk)
    tex = texec.CircuitExecutor(prog, tk)
    (_, launched, _), = tex.family_calls(1, 1)
    assert launched < tex.levels[1].wire_idx.shape[0]
    vals = inputs(prog, 1)
    jbuf0 = jex.encrypt_inputs(vals, np.random.default_rng(2))
    jfull = np.asarray(jex.run(jbuf0))
    jbuf1 = jexec._level_step(jk, None, jbuf0, *map(
        jnp.asarray, plan_arrays(jex.levels[0])))
    ckpt = str(tmp_path / "jax.npz")
    np.savez(ckpt, buf=np.asarray(jbuf1), level=0,
             num_levels=len(jex.levels))
    start = torch.from_numpy(np.array(jbuf0))
    assert np.array_equal(tex.run(start, checkpoint=ckpt).numpy(), jfull)
    own = str(tmp_path / "port.npz")
    assert np.array_equal(tex.run(start, checkpoint=own,
                                  checkpoint_every=1).numpy(), jfull)
    with np.load(own) as z:
        assert int(z["level"]) == len(tex.levels) - 2
    assert np.array_equal(tex.run(start, checkpoint=own).numpy(), jfull)


# ------------------------------------ the benchmark's programs, keyless

def shell_executor(prog, families, staged_p=None):
    """An executor of ``prog`` over key shells (its plan and launch layout
    read no key material), K1's fast keys stood in for by their
    orientation."""
    def shell(params):
        return T.TFHEKeys(params, None, None, torch.empty(0), None)

    fast = SimpleNamespace(orientation="fused_otf", route=None, limbs=4)
    if staged_p is None:
        return texec.CircuitExecutor(prog, shell(families[0]),
                                     fast_keys=fast)
    keys = StagedKeys(staged_p, *map(shell, families))
    return texec.CircuitExecutor(prog, keys, fast_keys=(fast, fast))


def program_executor(name):
    """The shell executor of a benchmark configuration's program, its
    families and each level's real bootstraps a family call."""
    if name == "aes128_p4":
        families = [PRESETS[name][0]]
        ex = shell_executor(parse_lbf(AES_LBF.read_text()), families)
        return ex, families, [[nb] for nb in texec.native_level_boots(
            ex.prog)]
    preset = STAGED_PRESETS[name]
    families = [preset.fam1, preset.fam2]
    ex = shell_executor(parse_lbf(KREYVIUM_LBF.read_text()), families,
                        preset.p)
    return ex, families, [[ns + f1, ns + f2]
                          for ns, f1, f2 in ex.plan.level_routes]


@pytest.mark.parametrize("name,v", [("aes128_p4", 8), ("aes128_p4", 1),
                                    ("kreyvium_p10_staged", 8)])
def test_programs_launch_the_packed_counts(name, v):
    """At AES-128's and Kreyvium's programs on the card each family call
    launches ``launch_rows`` of its real bootstraps, whole tiles of the
    plan that serves them and no more than the bucket; the launch record's
    entries carry those counts and the route that count takes, which is
    the route of the real rows; the graph groups split the plan's where
    the layout changes."""
    ex, families, reals = program_executor(name)
    buf = SimpleNamespace(shape=(ex.num_wires, v, 1),
                          device=torch.device("cuda"))
    # each family's route where it keeps off the ring (every launch held
    # in one wave of the small tiles), else each launch's own
    routes = [None if RM.takes_ring(p, [v * w[i] for w in reals])
              else "k1s" for i, p in enumerate(families)]
    launched = padded = 0
    with profiling.collect():
        for lv, want in enumerate(reals):
            calls = ex.family_calls(lv, v, card=True)
            entries = ex._launches(buf, lv)
            buckets = [a.shape[0] for a in ex.levels[lv].arrays()[::6]]
            for (fam, n, real), w, p, e, nb, route in zip(
                    calls, want, families, entries, buckets, routes):
                assert real == v * w
                assert n == RM.launch_rows(p, w, v, "fused_otf", 4, route)
                assert (e.launched, e.real) == (n, real)
                if not w:
                    continue
                assert v * w <= n <= v * nb
                tile = RM.launch_tile(p, v * w, "fused_otf", 4, route)
                assert n % tile == 0 or n == v * nb
                assert e.path == (route or RM.k1_route(p, n)) == (
                    route or RM.k1_route(p, v * w))
                launched += n
                padded += n - v * w
    # the layout pads a few percent where the buckets pad 28-29%
    assert 100 * padded / launched < {8: 5, 1: 10}[v]
    groups = ex.launch_groups(v)
    layout = ex.launch_layout(v)
    assert [g.start for g in groups] == [0] + [g.stop for g in groups[:-1]]
    assert all(len({layout[lv] for lv in g}) == 1 for g in groups)
    assert {g.start for g in ex.groups} <= {g.start for g in groups}


@pytest.mark.parametrize("name,v,want", [
    ("aes128_p4", 8, {("k1", None): 227, ("k1s", (16, 16)): 3}),
    ("aes128_p4", 1, {("k1s", (16, 16)): 192, ("k1s", (16, 8)): 38}),
    ("kreyvium_p10_staged", 8, {("k1", None): 27, ("k1s", (16, 12)): 1})])
def test_programs_launch_the_chosen_kernels(name, v, want):
    """The benchmark's cells, from the committed calibration: the cost
    model chooses each family call's launch once
    (``CircuitExecutor.launch_choices``), and the kernel runs its route and
    small-tile (tile, cluster), which is the plan the model prices at the
    count launched (``launch_plan``): AES-128 at V=8 227 ring launches
    and 3 small-tile ones, at V=1 all 230 on the small-tile plan (each
    held in one wave of its tiles: ``takes_ring``), and Kreyvium at V=8
    27 ring launches and one on tiles of 16."""
    ex, families, _ = program_executor(name)
    cal = calibration()
    got = {}
    for lv, calls in enumerate(ex.launch_choices(v)):
        for c, p in zip(calls, families):
            if not c.launched:
                continue
            got[c.route, c.tile] = got.get((c.route, c.tile), 0) + 1
            assert c.path == c.route
            plan = fbr.k1_plan(
                c.launched, p, cal["sms"], 4, *(c.tile or (None, None)),
                resident=lambda q: cal["resident"].get(
                    RM.resident_key("fused_otf", 4, q, p),
                    cal["sms"] // q.cluster), route=c.route)
            assert plan == RM.launch_plan(p, c.launched, "fused_otf", 4,
                                          c.route)[0], lv
    assert got == want


def test_layout_reads_the_keys_limbs():
    """Each family call's launch is chosen at the limbs the fast keys hold
    (``FastKeys.limbs``), here K2's at 3 limbs, and with their route."""
    ex, families, reals = program_executor("aes128_p4")
    ex.fast_keys = SimpleNamespace(orientation="fused", route=None, limbs=3)
    for calls, (real,) in zip(ex.launch_choices(8), reals):
        assert calls == (RM.launch_choice(AES, real, 8, "fused", 3),)
        assert calls[0].path == "k2" and calls[0].route is None


# -------------------------------- the small-tile plan at the packed counts

AES = PRESETS["aes128_p4"][0]


def test_aes_small_tile_plan_by_waves():
    """At AES-128's family: up to 7 tiles of 16 (112 rows) 16 on 16 CTAs,
    one wave; 128 rows the ring's one wave of 64 on 12, priced below the
    small tiles' 16 on 8 (which a family whose launches all fit one wave of
    small tiles keeps: ``takes_ring``); the launches of eight evaluations
    of 40 to 56 bootstraps (320 to 448 rows) the ring kernel's one wave."""
    for rows in (1, 16, 97, 112):
        plan, waves = RM.launch_plan(AES, rows, "fused_otf")
        assert (plan.cb, plan.cluster, waves) == (16, 16, 1)
    plan, waves = RM.launch_plan(AES, 128, "fused_otf")
    assert (plan.cb, plan.cluster, plan.pair, waves) == (64, 12, 1, 1)
    plan, waves = RM.launch_plan(AES, 128, "fused_otf", route="k1s")
    assert (plan.cb, plan.cluster, waves) == (16, 8, 1)
    assert not RM.takes_ring(AES, (16, 112, 128, 176))
    assert RM.takes_ring(AES, (16, 128, 1024))
    for rows in range(320, 449, 64):
        assert RM.k1_route(AES, rows) == "k1"
        plan, waves = RM.launch_plan(AES, rows, "fused_otf")
        assert isinstance(plan, fbr.K1Plan) and waves == 1


def test_small_tile_price_is_flat_within_a_wave():
    """The small-tile price rises with the rows and is one price for every
    count of a plan and its waves."""
    for params in (AES, PRESETS["anchor"][0],
                   STAGED_PRESETS["kreyvium_p10_staged"].fam2):
        last, by = 0.0, {}
        for rows in range(1, 2049, 3):
            us = RM.small_tile_us(params, rows)
            assert us >= last
            last = us
            by.setdefault(RM.small_tile_plan(params, rows), set()).add(us)
        assert all(len(v) == 1 for v in by.values()) and len(by) > 3


def test_auto_still_takes_k1_at_aes128():
    """The price ``auto`` compares the kernels by is summed over powers of
    two, and AES-128 keeps K1."""
    assert RM.ROWS == (64, 128, 256, 512, 1024, 2048, 4096, 8192)
    assert RM.kernel_us(AES, "fused_otf") < RM.kernel_us(AES, "fused")
    assert RM.pick_kernel(AES, 80e9) == "fused_otf"
    assert calibration()["families"][RM.entry_key(AES, "k1s")]["plans"]
