"""The comparison catches what it has to: a run with the timed path broken
underneath comes out not correct (the state returned unchanged, half of the
batch left out, an answer altered where it is produced), and so does the
control, the program with its bootstrapping key one limb short, at a size
a test run can hold.  The harness's look for a card is skipped: the runs
are on the CPU through the plain versions of the kernels."""

import pytest

from bench_h100.harness.cell import is_correct, run_cell
from bench_h100.reference.lwe import delta
from tfhe_fbs_map_tpu_torch.runtime import executor
from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor

SEED = 2 ** 32 + 11


def unchanged(monkeypatch, p):
    monkeypatch.setattr(CircuitExecutor, "run",
                        lambda self, buf, **kw: buf.clone())


def half_batch(monkeypatch, p):
    run = CircuitExecutor.run

    def half(self, buf, **kw):
        out = run(self, buf, **kw)
        v = out.shape[1]
        out[:, v // 2:] = buf[:, v // 2:]
        return out
    monkeypatch.setattr(CircuitExecutor, "run", half)


def altered(monkeypatch, p):
    fbs = executor._run_fbs

    def alter(*a, **kw):
        out = fbs(*a, **kw)
        out[0, -1] += delta(p)             # one answer a call, one step off
        return out
    monkeypatch.setattr(executor, "_run_fbs", alter)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("kind", ["native", "staged"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, kind,
                                            fault):
    cell = tiny(kind)
    fault(monkeypatch, cell.config["p"])
    run = run_cell(cell, SEED, 0.0, False, ["cpu"], batches=2)
    assert run.compared["wrong_bits"]["value"] > 0
    assert run.failed > 0
    assert not is_correct(run)


@pytest.mark.parametrize("kind", ["native", "staged"])
def test_the_control_is_not_correct(tiny, kind):
    """Sound runs and the 3-limb control on three seeds each, through the
    fused orientation's plain kernels; the limit between them, at this
    size, is failed by every control run alone."""
    orient = "fused" if kind == "native" else "fused_otf"
    sound, control = [], []
    for seed in (SEED, SEED + 1, SEED + 2):
        for limbs, out in ((4, sound), (3, control)):
            run = run_cell(tiny(kind, orientation=orient), seed, 0.0, False,
                           ["cpu"], bsk_limbs=limbs, batches=1)
            out.append(run)
    lower = max(r.compared["noise_rms"]["value"] for r in sound)
    upper = min(r.compared["noise_rms"]["value"] for r in control)
    assert upper > 3 * lower
    assert all(is_correct(r) for r in sound)
    limit = (lower + upper) / 2
    for r in control:
        r.compared["noise_rms"]["limit"] = limit
        assert not is_correct(r)


def test_the_exchange_between_positions_left_out(tiny, monkeypatch):
    """Under a dp mesh (two positions of the CPU): every position but the
    first returns its inputs, as if its shard were never computed and
    brought back."""
    from bench_h100.harness.spec import Cell

    run = CircuitExecutor.run

    def first_only(self, buf, **kw):
        out = run(self, buf, **kw)
        return out[:1] + [b.clone() for b in buf[1:]]
    cell = tiny("native")
    dp2 = Cell(cell.name + ".dp2", 2, cell.config,
               {"name": "b8.dp2", "batch": 8, "dp": 2})
    sound = run_cell(dp2, SEED, 0.0, False, ["cpu", "cpu"], batches=2)
    assert is_correct(sound)
    monkeypatch.setattr(CircuitExecutor, "run", first_only)
    broken = run_cell(dp2, SEED, 0.0, False, ["cpu", "cpu"], batches=2)
    assert broken.compared["wrong_bits"]["value"] > 0
    assert not is_correct(broken)
