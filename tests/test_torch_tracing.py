"""The executor's launch record and host spans (``utils.profiling``), and
the benchmark's readers of them.

On the CPU: without a profiler the record stays empty and ``LAUNCHES``
counts as before; under one, native, staged and dp=2 runs record one
entry a family call and position whose counts add up to the plan's, level
by level, with their spans nested in the trace; the readers
``launch_pad_share``, ``issue_idle_share`` and ``model_error`` run on the
benchmark's small cells and on a trace made up here; the runtime CLI's
``--trace``.  GPU-marked: traced small cells on the card, with no span of
the program among the device's operations and the record's kernel
entries paired one to one with the trace's blind-rotation kernels.  This
file imports no JAX:

    python -m pytest --noconftest tests/test_torch_tracing.py -q   # on a card
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100.harness.cell import plan_calls, run_cell
from bench_h100.harness.spec import metric_reader
from bench_h100.harness.trace import BATCH, Trace, is_blind_rotation
from bench_h100.tests.conftest import TINY_STAGED_FAMILIES, tiny_cell
from tfhe_fbs_map_tpu_torch.frontend.circuits import BENCH_GENERATORS
from tfhe_fbs_map_tpu_torch.frontend.circuits import build_bench
from tfhe_fbs_map_tpu_torch.frontend.mapping.heuristic import HeuristicMapper
from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import (launch_choice,
                                                             launch_rows,
                                                             launch_us)
from tfhe_fbs_map_tpu_torch.parallel.mesh import make_mesh
from tfhe_fbs_map_tpu_torch.runtime import executor as executor_module
from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
from tfhe_fbs_map_tpu_torch.tfhe import TEST_PARAMS, generate_keys
from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys
from tfhe_fbs_map_tpu_torch.utils import profiling

# many test workers share the cores: one torch thread each
torch.set_num_threads(1)

READERS = ("launch_pad_share", "issue_idle_share", "model_error")


def mapped(circuit, p):
    prog = HeuristicMapper(cone_merger="search", fbs_size=p).map(circuit)
    prog.remove_dangling_nodes()
    return prog


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """A full adder mapped at p=4 and one Kreyvium round at p=10: the
    programs (``prog``) and their ``.lbf`` paths (the small cells')."""
    d = tmp_path_factory.mktemp("programs")
    out = {}
    for kind, circuit, p in (
            ("native", build_bench("full_adder"), 4),
            ("staged", BENCH_GENERATORS["kreyvium_iter_v1"](), 10)):
        prog = mapped(circuit, p)
        path = d / f"{kind}.lbf"
        with open(path, "w") as f:
            prog.write_lbf(f)
        out[kind], out[f"{kind}_prog"] = str(path), prog
    return out


def executor(programs, kind, device="cpu", orientation=None, dp=1):
    """An executor of the small program ``kind`` (native, staged) on
    ``device`` (``dp`` positions of it), through ``orientation`` (None: the
    generic bootstrap), and a buffer of 4 evaluations."""
    prog = programs[f"{kind}_prog"]
    if kind == "native":
        keys = generate_keys(TEST_PARAMS, seed=3, device=device)
        fast = (prepare_fast_keys(keys, orientation=orientation)
                if orientation else None)
    else:
        fam1, fam2 = (TFHEParams(**f) for f in TINY_STAGED_FAMILIES)
        keys = generate_staged_keys(10, fam1, fam2, seed=3, device=device)
        fast = (tuple(prepare_fast_keys(k, orientation=orientation)
                      for k in (keys.keys1, keys.keys2))
                if orientation else None)
    mesh = make_mesh([device] * dp) if dp > 1 else None
    ex = CircuitExecutor(prog, keys, fast_keys=fast, mesh=mesh)
    rng = np.random.default_rng(4)
    values = {n.name: rng.integers(0, 2, 4) for n in prog.nodes
              if n.kind == "input"}
    return ex, ex.encrypt_inputs(values, rng)


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


# ------------------------------------------------------------ the record

@pytest.mark.parametrize("orientation", [None, "fused", "fused_otf"])
def test_untraced_runs_leave_no_record(programs, orientation):
    """With no profiler recording, a run makes no entry, no span and no
    kernel launch on the CPU (``LAUNCHES`` counts the card's)."""
    ex, buf = executor(programs, "native", orientation=orientation)
    profiling.RECORD.clear()
    before = dict(fbr.LAUNCHES)
    assert not profiling.tracing()
    assert profiling.span("tfhe.run") is profiling.span("tfhe.level 0")
    ex.run(buf)
    assert profiling.RECORD == [] and fbr.LAUNCHES == before
    assert not profiling.collecting()


@pytest.mark.parametrize("kind,orientation,dp", [
    ("native", None, 1), ("native", "fused_otf", 1), ("native", "fused", 2),
    ("staged", "fused_otf", 1), ("staged", None, 2)])
def test_traced_runs_record_the_plan(programs, kind, orientation, dp):
    """Under a profiler each run is a batch of the record: one entry a
    family call and position, in level order, whose real bootstraps add up
    to the plan's (``plan_calls``, the harness's count) times the batch,
    level by level, and whose ciphertexts launched to the executor's launch
    layout (``family_calls``), no more than the plan's slots."""
    ex, buf = executor(programs, kind, orientation=orientation, dp=dp)
    traced(lambda: [ex.run(buf) for _ in range(2)])
    got = profiling.batches(2)
    assert got is not None and profiling.batches(3) is None
    calls = plan_calls(ex, [None, None])
    per_level = 2 if ex.staged else 1
    paths = {"native": {None: {"generic"}, "fused_otf": {"k1"},
                        "fused": {"k2"}},
             "staged": {None: {"generic"}, "fused_otf": {"k1", "k1s"}}}
    for b, batch in enumerate(got):
        assert {e.batch for e in batch} == {b}
        assert [e.level for e in batch] == sorted(e.level for e in batch)
        assert {e.path for e in batch} == paths[kind][orientation]
        assert {e.device for e in batch} == {"cpu"}
        for lv in range(len(ex.levels)):
            mine = [e for e in batch if e.level == lv]
            want = calls[lv * per_level:(lv + 1) * per_level]
            assert len(mine) == dp * sum(1 for *_, s in want if s)
            assert sum(e.launched for e in mine) == dp * sum(
                n for _, n, _ in ex.family_calls(lv, 4 // dp))
            assert sum(e.launched for e in mine) <= 4 * sum(
                s for *_, s in want)
            assert sum(e.real for e in mine) == 4 * sum(
                r for _, r, _ in want)
            assert {e.family for e in mine} <= (
                {"fam1", "fam2"} if ex.staged else {"native"})


def test_each_profiler_session_starts_an_empty_record(programs):
    """A traced run after the program saw the profiler off starts the
    record anew, its batches counted from 0."""
    ex, buf = executor(programs, "native")
    traced(lambda: [ex.run(buf) for _ in range(3)])
    first = len(profiling.RECORD)
    ex.run(buf)                                   # untraced
    traced(lambda: ex.run(buf))
    assert len(profiling.RECORD) == first // 3
    assert {e.batch for e in profiling.RECORD} == {0}
    assert profiling.batches(1) and profiling.batches(2) is None


def test_collect_stamps_each_call_and_counts_kernels(programs):
    """``collect`` gathers a step's entries whether or not a profiler
    records, and with a stamp puts each call's blind rotation between two
    stamps; ``launch_counts`` keys the fused kernels as ``LAUNCHES``."""
    ex, buf = executor(programs, "staged", orientation="fused_otf")
    ticks = iter(range(1000))
    with profiling.collect(stamp=lambda: next(ticks)) as got:
        for lv in range(len(ex.levels)):
            ex.step(buf, lv)
    assert len(got.entries) == len(got.spans) == sum(
        1 for lv in range(len(ex.levels))
        for _, nb, _ in ex.family_calls(lv) if nb)
    assert all(a < b for _, a, b in got.spans)
    assert [s[0] for s in got.spans] == got.entries
    assert profiling.launch_counts(got.entries) == {
        "k1": len(got.entries), "k2": 0}

    def path(orientation, params=TEST_PARAMS):
        return launch_choice(params, 16, 4, orientation, card=False).path

    assert path("fused_otf") == "k1"
    assert path("fused_otf", dataclasses.replace(
        TEST_PARAMS, poly_size=128)) == "k1s"
    assert path("fused") == "k2"
    assert path("matmul") == "matmul"
    assert path(None) == "generic"


def test_capture_takes_counts_back_from_the_record(monkeypatch):
    """A capture's kernel launches come back out of ``LAUNCHES`` and
    ``K1_KERNELS`` from its entries of the launch record, by the kernel
    each path runs at its family's N (``k1``: the ring kernel; ``k1s``:
    the small-N kernel below N=256, the small-tile plan at or above it),
    and each replay of the graph adds them again."""
    def entry(family, path):
        return profiling.Launch(None, 0, family, "cuda:0", path, 16, 16)

    entries = [entry("fam1", "k1"), entry("fam1", "k1s"),
               entry("fam2", "k1s"), entry("fam2", "k1s"),
               entry("fam2", "k2"), entry("fam1", "generic"),
               entry("fam2", "matmul")]
    monkeypatch.setattr(fbr, "LAUNCHES", dict.fromkeys(fbr.LAUNCHES, 10))
    monkeypatch.setattr(fbr, "K1_KERNELS",
                        dict.fromkeys(fbr.K1_KERNELS, 10))
    counts = executor_module._take_back(entries, {"fam1": 512, "fam2": 128})
    assert fbr.LAUNCHES == {"k1": 6, "k2": 9}
    assert fbr.K1_KERNELS == {"k1_kernel": 9, "k1s_kernel": 8,
                              "k1s_kernel_wide": 9}
    graphs = executor_module._Graphs([])
    graphs.graphs.append(executor_module._Graph(
        SimpleNamespace(replay=lambda: None), tuple(entries), counts, "g"))
    graphs.replay()
    graphs.replay()
    assert fbr.LAUNCHES == {"k1": 14, "k2": 11}
    assert fbr.K1_KERNELS == {"k1_kernel": 11, "k1s_kernel": 12,
                              "k1s_kernel_wide": 11}


def test_capture_takes_ring_epilogues_back(monkeypatch):
    """A capture's ring launches (path ``k1`` at N ≥ 256) come back out of
    ``K1_EPILOGUES`` under ``reduce``, the ACC epilogue of both ring
    schedules, and each replay adds them again; the small-N kernels, K2
    and the library paths count none, and no launch counts under
    ``load_store``."""
    def entry(family, path):
        return profiling.Launch(None, 0, family, "cuda:0", path, 16, 16)

    entries = [entry("fam1", "k1"), entry("fam1", "k1"),
               entry("fam2", "k1s"), entry("fam1", "k1s"),
               entry("fam2", "k2"), entry("fam1", "generic")]
    assert set(fbr.K1_EPILOGUES) == {"reduce", "load_store"}
    monkeypatch.setattr(fbr, "K1_EPILOGUES",
                        dict.fromkeys(fbr.K1_EPILOGUES, 10))
    monkeypatch.setattr(fbr, "LAUNCHES", dict.fromkeys(fbr.LAUNCHES, 10))
    monkeypatch.setattr(fbr, "K1_KERNELS",
                        dict.fromkeys(fbr.K1_KERNELS, 10))
    counts = executor_module._take_back(entries, {"fam1": 512, "fam2": 128})
    assert fbr.K1_EPILOGUES == {"reduce": 8, "load_store": 10}
    graphs = executor_module._Graphs([])
    graphs.graphs.append(executor_module._Graph(
        SimpleNamespace(replay=lambda: None), tuple(entries), counts, "g"))
    for _ in range(3):
        graphs.replay()
    assert fbr.K1_EPILOGUES == {"reduce": 14, "load_store": 10}
    assert fbr.K1_KERNELS["k1_kernel"] == fbr.K1_EPILOGUES["reduce"]


# ------------------------------------------ the spans and the readers

def packed_pad_share(run) -> float:
    """The padding share of the window's launches, each entry's launch
    held to the packed count of its real bootstraps
    (``runtime_model.launch_rows``; off the card no kernel has tiles)."""
    cfg = run.cell.config
    fams = [TFHEParams(**f) for f in cfg["families"]]
    params = {"native": fams[0], "fam1": fams[0], "fam2": fams[-1]}
    orients = {"k1": "fused_otf", "k1s": "fused_otf", "k2": "fused"}
    v = run.batch // run.dp
    launched = real = 0
    for batch in profiling.batches(len(run.times)):
        for e in batch:
            orient = orients.get(e.path) if e.device != "cpu" else None
            assert e.launched == launch_rows(
                params[e.family], e.real // v, v, orient,
                int(cfg["bsk_limbs"]))
            launched += e.launched
            real += e.real
    return 100.0 * (launched - real) / launched

@pytest.mark.parametrize("kind", ["native", "staged"])
def test_small_cells_spans_and_readers(programs, kind):
    """A traced small cell on the CPU: one ``tfhe.run`` in each batch's
    window and the levels' ``tfhe.level`` inside it, in order;
    ``launch_pad_share`` is the padding of the launch layout's counts, no
    more than ``pad_share``, the plan's; the readers of the device trace
    find nothing to read without a card."""
    run = run_cell(tiny_cell(programs, kind), 2 ** 31 + 7, 0.0, True,
                   ["cpu"], batches=2)
    host = run.trace.host
    runs = sorted((a, b) for n, a, b in host if n == "tfhe.run")
    assert len(runs) == len(run.trace.windows) == 2
    for (w0, w1), (a, b) in zip(run.trace.windows, runs):
        assert w0 <= a < b <= w1
        levels = sorted((s, e, n) for n, s, e in host
                        if n.startswith("tfhe.level ") and a <= s < b)
        assert all(e <= b for _, e, _ in levels)
        assert [int(n.split()[1]) for *_, n in levels] == list(
            range(len(levels)))
        assert levels
    assert metric_reader("launch_pad_share")(run) == pytest.approx(
        packed_pad_share(run), abs=1e-9)
    assert metric_reader("launch_pad_share")(run) <= \
        metric_reader("pad_share")(run) + 1e-9
    assert metric_reader("issue_idle_share")(run) is None
    assert metric_reader("model_error")(run) is None


def test_readers_without_a_record_read_nothing(programs, monkeypatch):
    """On a program that keeps no launch record every new reader returns
    None, and raises nothing."""
    run = run_cell(tiny_cell(programs, "native"), 5, 0.0, True, ["cpu"],
                   batches=1)
    monkeypatch.delattr(profiling, "batches")
    for name in READERS:
        assert metric_reader(name)(run) is None


def made_up_run():
    """One batch of 1,000 µs on card 0: K2 at 100–400 µs, a copy at
    450–500, K2 at 500–900; the host inside ``tfhe.run`` from 10 to 980 µs,
    its last replay ending at 600; and the record of its two K2 calls."""
    trace = Trace(
        windows=[(0.0, 1000.0)],
        ops={0: [("void fbr::k2::k2_kernel<4, 64>", 100.0, 400.0),
                 ("copy", 450.0, 500.0),
                 ("void fbr::k2::k2_kernel<4, 128>", 500.0, 900.0)]},
        host=[(BATCH, 0.0, 1000.0), ("tfhe.run", 10.0, 980.0),
              ("tfhe.copy_in", 12.0, 20.0),
              ("tfhe.replay g0 levels 0-0 cuda:0", 20.0, 30.0),
              ("tfhe.replay g1 levels 1-1 cuda:0", 30.0, 600.0),
              ("tfhe.copy_out", 600.0, 610.0)])
    cfg = {"families": [dataclasses.asdict(TEST_PARAMS)], "bsk_limbs": 4,
           "staged": False}
    run = SimpleNamespace(trace=trace, times=[1e-3],
                          cell=SimpleNamespace(config=cfg))
    record = [profiling.Launch(0, lv, "native", "cuda:0", "k2", n, n - 1)
              for lv, n in ((0, 64), (1, 1024))]
    return run, record


def test_readers_on_a_made_up_trace(monkeypatch):
    """The readers' arithmetic: the idle span that begins before the last
    replay ends is the issue's (50 of the 250 idle µs), the closing one
    the drain's; the model's error is against each call's busy time from
    the previous kernel's end (300 and 450 µs); with a kernel the record
    lacks there is nothing to read."""
    run, record = made_up_run()
    monkeypatch.setattr(profiling, "batches", lambda n: [record])
    assert metric_reader("idle_share")(run) == pytest.approx(25.0)
    assert metric_reader("issue_idle_share")(run) == pytest.approx(5.0)
    assert metric_reader("launch_pad_share")(run) == pytest.approx(
        100 * 2 / 1088)
    pred = [launch_us(TEST_PARAMS, n, "fused", 4, False) for n in (64, 1024)]
    assert metric_reader("model_error")(run) == pytest.approx(
        100 * (abs(pred[0] - 300) + abs(pred[1] - 450)) / 750)
    monkeypatch.setattr(profiling, "batches", lambda n: [record[:1]])
    assert metric_reader("model_error")(run) is None
    # a second batch whose first kernel the trace shows begun before the
    # first batch's end: its piece in the first window is not counted there
    run.trace.windows.append((2000.0, 3000.0))
    run.trace.ops[0] += [("void fbr::k2::k2_kernel<4, 64>", 900.0, 1000.0),
                         ("void fbr::k2::k2_kernel<4, 64>", 2000.0, 2300.0)]
    run.trace.host.append(("tfhe.run", 2010.0, 2980.0))
    run.times.append(1e-3)
    monkeypatch.setattr(profiling, "batches",
                        lambda n: [record, [record[0]._replace(batch=1)]])
    assert metric_reader("model_error")(run) == pytest.approx(
        100 * (abs(pred[0] - 300) + abs(pred[1] - 450) + abs(pred[0] - 300))
        / 1050)
    run.trace.host = [h for h in run.trace.host if h[0] != "tfhe.run"]
    assert metric_reader("issue_idle_share")(run) is None


# ----------------------------------------------------------- the CLI

def test_cli_trace_writes_the_spans(programs, tmp_path, capsys):
    """``--trace DIR`` writes the Chrome trace of the timed run with the
    executor's spans, and leaves the JSON line's keys as they were."""
    from tfhe_fbs_map_tpu_torch.runtime.cli import main

    base = [programs["native"], "--test-params", "--batch", "2",
            "--device", "cpu", "--repeat", "2"]
    lines = []
    for extra in ([], ["--trace", str(tmp_path / "tr")]):
        assert main(base + extra) == 0
        lines.append(json.loads(capsys.readouterr().out.strip()
                                .splitlines()[-1]))
    assert list(lines[0]) == list(lines[1]) and lines[1]["bit_exact"]
    (path,) = Path(tmp_path / "tr").glob("trace_*.json")
    names = {e.get("name", "") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "tfhe.run" in names and "tfhe.level 0" in names


# ------------------------------------------------------------- the card

@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "staged"])
def test_traced_small_cells_on_the_card(programs, kind):
    """On the card the spans stay on the host (no ``tfhe.`` name among the
    device's operations), each batch's blind-rotation kernels are the
    record's kernel entries one to one, and the new readers read
    something, the shares in [0, 100] with the issue's idle within the
    whole idle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = run_cell(tiny_cell(programs, kind, noise_limit=0.05), 2 ** 31 + 3,
                   0.0, True, ["cuda:0"], batches=2)
    tr = run.trace
    assert tr.ops and not any(n.startswith("tfhe.") for ops in tr.ops.values()
                              for n, *_ in ops)
    assert any(n.startswith("tfhe.replay ") for n, *_ in tr.host)
    (card,) = tr.devices()
    for (w0, w1), batch in zip(tr.windows, profiling.batches(2)):
        kernels = [n for n, a, b in tr.ops[card]
                   if a < w1 and b > w0 and is_blind_rotation(n)]
        entries = [e for e in batch if e.path in profiling.KERNEL_PATHS]
        assert len(kernels) == len(entries) > 0
        assert {e.device for e in batch} == {"cuda:0"}
    values = {m: metric_reader(m)(run) for m in READERS + ("idle_share",)}
    assert all(v is not None and v >= 0 for v in values.values()), values
    # the shares lie in [0, 100]; the model's error is relative to the
    # measured time and passes 100% where the model prices a call at more
    # than twice its time (these families' calls take tens of µs)
    assert values["launch_pad_share"] <= 100, values
    assert values["issue_idle_share"] <= values["idle_share"] <= 100, values
    assert values["launch_pad_share"] == pytest.approx(
        packed_pad_share(run))
    assert values["launch_pad_share"] <= metric_reader("pad_share")(run) \
        + 1e-9


@pytest.mark.gpu
def test_graphs_keep_their_entries_and_launches(programs):
    """A capture launches nothing and keeps each graph's entries; an
    untraced replay adds its kernel launches and no entry, a traced one
    appends the graphs' entries to the record as one batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ex, buf = executor(programs, "native", "cuda", "fused_otf")
    before = dict(fbr.LAUNCHES)
    assert ex.capture(buf) == len(ex.launch_groups(buf.shape[1]))
    torch.cuda.synchronize()
    assert fbr.LAUNCHES == before
    graphs = next(iter(ex._graphs.values())).graphs
    assert sum(len(g.launches) for g in graphs) == len(ex.levels)
    profiling.RECORD.clear()
    ex.run(buf)
    torch.cuda.synchronize()
    assert profiling.RECORD == []
    assert fbr.LAUNCHES["k1"] - before["k1"] == len(ex.levels)
    with profile(activities=[ProfilerActivity.CPU]):
        ex.run(buf)
    assert [e.level for e in profiling.RECORD] == list(range(len(ex.levels)))
    assert {e.batch for e in profiling.RECORD} == {0}
