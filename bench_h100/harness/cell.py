"""One run of a cell: set-up, the measured window, the comparison.

Set-up follows the runtime CLI's sequence (``runtime/cli.py``) through the
port's own functions: read the program, make the keys from secrets the
benchmark draws, pick the kernels (``pick_orientations``), build the fast
keys, build the executor (under a dp mesh for a traffic with ``dp`` > 1),
encrypt the pool of inputs and capture the graphs.  The window is a closed
loop of batches: each batch of V fresh evaluations is one call of
``CircuitExecutor.run``, timed on the host clock from the call to the
synchronisation after it, until the batches' time reaches ``seconds``.
After the window the program's state is freed and every evaluation is
judged by the plain reference (``reference/``).
"""

from __future__ import annotations

import contextlib
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..reference import check as ref_check
from ..reference.lbf import read_lbf
from . import roofline
from .spec import HERE, Cell
from .trace import BATCH, Trace, reduce_profile

__all__ = ["Run", "run_cell", "is_correct", "sub_seed", "plan_calls"]


def sub_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed of its own for each use of the run's ``--seed``."""
    words = np.random.SeedSequence([seed, *tag]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@dataclass
class Run:
    """What a run measured and counted; the metric readers read it."""
    cell: Cell
    batch: int
    dp: int
    setup_s: float
    times: list                   # host seconds of each batch
    slots: int                    # launched bootstrap slots an evaluation
    real: int                     # real bootstraps an evaluation
    least_rotation_s: float       # a batch's, summed over its shards
    least_batch_s: float          # a batch's on its cards (max over shards)
    trace: Trace | None = None
    compared: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0


def plan_calls(ex, families: list[dict]) -> list[tuple[dict, int, int]]:
    """(family, real bootstraps, launched slots) of every bootstrap call of
    one evaluation, from the executor's compiled plan."""
    calls = []
    for lv in ex.levels:
        if ex.staged:
            ns = lv.n_splits
            real1 = int(np.sum(lv.out_rows1 != ex.dummy_row)) + ns
            real2 = int(lv.out_rows.shape[0]
                        - np.sum(lv.out_rows == ex.dummy_row))
            calls += [(families[0], real1, lv.wire_idx1.shape[0]),
                      (families[1], real2, lv.wire_idx2.shape[0])]
        else:
            real = int(np.sum(lv.out_rows != ex.dummy_row))
            calls.append((families[0], real, lv.wire_idx.shape[0]))
    return calls


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _log(*a) -> None:
    print("#", *a, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             devices: list, t_start: float | None = None,
             bsk_limbs: int | None = None,
             batches: int | None = None) -> Run:
    """Set up ``cell`` on ``devices`` (one a dp position), measure for
    ``seconds``, judge every evaluation.  ``t_start``: the process's start
    on the host clock (set-up counts from it).  ``bsk_limbs``: the key
    limbs to build (default the configuration's; the control builds
    fewer).  ``batches``: run exactly this many batches whatever their
    time (the tests' small programs)."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
    from tfhe_fbs_map_tpu_torch.parallel.mesh import make_mesh
    from tfhe_fbs_map_tpu_torch.runtime.cli import (free_memory,
                                                    pick_orientations)
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe.keys import generate_keys
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
    from tfhe_fbs_map_tpu_torch.tfhe.staged import StagedKeys

    t_start = time.time() if t_start is None else t_start
    cfg, traffic = cell.config, cell.traffic
    v, dp = int(traffic["batch"]), int(traffic.get("dp", 1))
    devices = [torch.device(d) for d in devices][:dp]
    if len(devices) < dp or v % dp:
        raise ValueError(f"traffic {traffic['name']}: batch {v} over dp={dp}"
                         f" needs {dp} devices dividing it")
    dev0 = devices[0]
    limbs = cfg["bsk_limbs"] if bsk_limbs is None else bsk_limbs
    families = cfg["families"]
    fam_params = [TFHEParams(**f) for f in families]
    text = (HERE / cfg["program"]).read_text()

    # --- the program and the keys, from secrets drawn here ---------------
    prog = parse_lbf(text)
    g = torch.Generator(device=dev0).manual_seed(sub_seed(seed, 1))
    n, big = fam_params[0].lwe_dim, fam_params[0].big_dim
    lwe_key = torch.randint(0, 2, (n,), generator=g, device=dev0,
                            dtype=torch.int32).cpu().numpy()
    secret = torch.randint(0, 2, (big,), generator=g, device=dev0,
                           dtype=torch.int32).cpu().numpy()
    rng = np.random.default_rng(sub_seed(seed, 2))
    fam_keys = [generate_keys(p, device=dev0, rng=rng, lwe_key=lwe_key,
                              glwe_key=secret.reshape(p.glwe_dim, -1))
                for p in fam_params]
    keys = (StagedKeys(p=int(cfg["p"]), keys1=fam_keys[0],
                       keys2=fam_keys[1]) if cfg["staged"] else fam_keys[0])
    mesh = make_mesh(devices, tp=1) if dp > 1 else None
    if cfg["orientation"] == "auto":
        free = (min(map(free_memory, devices)) if dev0.type == "cuda"
                else None)
        orients = pick_orientations(fam_params, dev0, free, bsk_limbs=limbs)
    else:
        orients = [cfg["orientation"]] * len(fam_params)
    fast = None
    if orients[0] != "generic":             # the plain bootstrap of the CPU
        fast = [prepare_fast_keys(k, orientation=o, bsk_limbs=limbs)
                for k, o in zip(fam_keys, orients)]
        fast = tuple(fast) if cfg["staged"] else fast[0]
    ex = CircuitExecutor(prog, keys, fast_keys=fast, mesh=mesh)
    _log(f"{cell.name}: {'+'.join(orients)}, {limbs} key limbs, "
         f"{len(ex.levels)} levels, {ex.num_bootstraps} bootstraps, "
         f"batch {v} over dp={dp}")

    # --- the yardstick's counts, from the compiled plan ------------------
    calls = plan_calls(ex, families)
    per_shard = v // dp
    least = [roofline.call_least_s(f, real * per_shard)
             for f, real, _ in calls]
    least_rotation = dp * sum(r for r, _ in least)
    least_batch = sum(b for _, b in least)
    slots = sum(s for *_, s in calls)
    real = sum(r for _, r, _ in calls)

    # --- the pool of inputs: as many batches as the window could hold at
    # the roofline, each with its own bits and encryption draws ------------
    pool_n = batches or math.ceil(seconds / least_batch) + 1
    names = [nd.name for nd in prog.nodes if nd.kind == "input"]
    gin = torch.Generator(device=dev0).manual_seed(sub_seed(seed, 3))
    bits = torch.randint(0, 2, (pool_n, len(names), v), generator=gin,
                         device=dev0, dtype=torch.int32).cpu().numpy()
    rows = torch.tensor([ex.input_rows[nm] for nm in names])
    pool, work = [], None
    for i in range(pool_n):
        values = dict(zip(names, bits[i]))
        buf = ex.encrypt_inputs(values, np.random.default_rng(
            sub_seed(seed, 4, i)))
        shards = buf if mesh is not None else [buf]
        pool.append([s[rows.to(s.device)].clone() for s in shards])
        if work is None:
            work = [torch.zeros_like(s) for s in shards]
        del buf, shards
    bufs = work if mesh is not None else work[0]
    if dev0.type == "cuda":
        ex.capture(bufs)
    _sync(devices)

    # --- the window -----------------------------------------------------
    times, outs = [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev0.type == "cuda" else [])
        prof = profile(activities=acts)
    setup_s = time.time() - t_start
    with prof if prof is not None else contextlib.nullcontext():
        for i in range(pool_n):
            for w, x in zip(work, pool[i]):
                w[rows.to(w.device)] = x
            _sync(devices)
            t0 = time.perf_counter()
            with (torch.profiler.record_function(BATCH) if trace
                  else contextlib.nullcontext()):
                out = ex.run(bufs)
                _sync(devices)
            times.append(time.perf_counter() - t0)
            outs.append(out)
            if batches is None and sum(times) >= seconds:
                break
        else:
            if batches is None:
                raise RuntimeError("the pool ran out before the window "
                                   "closed")
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    run = Run(cell, v, dp, setup_s, times, slots, real, least_rotation,
              least_batch, memory_peak_bytes=int(peak))
    if prof is not None:
        run.trace = reduce_profile(prof)
        del prof

    # --- free the program's state, then judge every evaluation -----------
    host = []
    for out in outs:
        shards = ex.mesh.leaders(out) if mesh is not None else [out]
        host.append(np.concatenate([s.cpu().numpy() for s in shards],
                                   axis=1))
    del ex, keys, fam_keys, fast, pool, work, bufs, outs, out
    if dev0.type == "cuda":
        torch.cuda.empty_cache()
    ref = read_lbf(text)
    tally = ref_check.Tally()
    for i, buf in enumerate(host):
        ref_check.judge(ref, int(cfg["p"]), secret,
                        dict(zip(names, bits[i])), buf, tally)
    limits = cfg["limits"]
    run.compared = {
        "wrong_bits": {"value": tally.wrong_bits,
                       "limit": limits["wrong_bits"]},
        "noise_rms": {"value": tally.noise_rms,
                      "limit": limits["noise_rms"]},
    }
    if tally.bad_buffers:
        run.compared["bad_buffers"] = {"value": tally.bad_buffers,
                                       "limit": 0}
    run.attempted, run.failed = tally.evaluations, tally.failed
    return run


def is_correct(run: Run) -> bool:
    """Every compared number within its limit, over a window that ran."""
    return run.attempted > 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in run.compared.values())
