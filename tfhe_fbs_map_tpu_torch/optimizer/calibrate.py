"""Calibrate the H100 cost model and runtime model on the card.

    python -m tfhe_fbs_map_tpu_torch.optimizer.calibrate
    python -m tfhe_fbs_map_tpu_torch.optimizer.calibrate --dry   # refit
    python -m tfhe_fbs_map_tpu_torch.optimizer.calibrate --only k1s
    python -m tfhe_fbs_map_tpu_torch.optimizer.calibrate --only k1

The port of ``experiments/calibrate_runtime.py``.  For each parameter family
(the presets anchor, p8, p16 and aes128_p4, both families of each staged
preset, the optimizer's native pick for Kreyvium-1152, and the p22 and p32
shapes), one family and kernel at a time, it times
``CircuitExecutor.step`` on a synthetic level of identity bootstraps at
several ciphertexts a call, through every kernel ``--orientation auto``
may run the family on (:func:`kernels`: a native family through K1 and,
where K2 serves it and its matrices fit the card, K2, whose calibrated
prices then decide between them; a staged one on K1, which runs it): CUDA
events around chained calls, the median of three repetitions, and the
fused kernel's own span inside every call; then the work around the
kernel alone, as ``CircuitExecutor.run`` executes a level: the replay of a
one-level CUDA graph captured with the kernel left out.  Ciphertexts a
call go from 64 to 8192 (``runtime_model.ROWS``), so K1's and K2's plans
cross wave boundaries.  It also times the generic path at one family, and
asks the card how many clusters it runs at once for every plan the model
can choose.

It then fits, and writes ``calibration_h100.json`` beside this file, with
the card's name and power limit as ``nvidia-smi`` prints them and the raw
points (``--dry`` refits from them):

* per family and kernel timed (key ``n,k,N,l,ks_l/<kernel>``): the
  kernel's fixed term and its time a wave unit (``kernel = F + waves · cb ·
  sms / cluster · τ``), and the work around the kernel (``a + b · rows ·
  (kN+1)``, from the points' ``around_ms``);
* per kernel: the median efficiency against the data sheet's int8 rate and
  the median fixed term, which families without an entry of that kernel
  take; the around fit across all points; the generic path's slowdown per
  bootstrap (over K2's roofline cost at its family); the free device
  memory K2's matrices may take.

K1's small-N kernel (N < 256) is timed apart, at the families of
:func:`small_families` (``raw["k1s_points"]``, and the clusters its plans
run at once in the resident table): their family entries and the
kernel-wide ``k1s`` fit (fixed term, efficiency and the median scale of
its per-boot cost), which a small-N family without an entry takes.  So is
its small-tile plan at N ≥ 256, at the families of :func:`wide_families`
and the launch sizes ``runtime_model.SMALL_ROWS``, on every tile and
cluster it is built for (:func:`time_wide`: the kernel alone, full length,
``raw["k1s_wide_plans"]``), and the clusters of each in the resident
table.  From those come each family's ``.../k1s`` entry (``points``: its
fastest plan's µs at each launch size; ``plans``: each tile and cluster's
µs by waves, which pick the plan and price it,
``runtime_model.small_tile_pick``) and their fit across families (``kernels
["k1s_wide"]``: at each launch size a fixed µs a step and a scale of the
per-boot cost, which prices the families without points).  The ring
kernel's points are timed with its route given (``FastKeys.route``), so
neither reads the other, and each K1 entry at N ≥ 256 keeps its kernel µs
at each launch size (``points``).  Every other entry is fitted from
``raw["points"]`` alone.  ``--only k1s`` times the small-N kernel alone
(both plans) and adds its points to the existing file, whose other entries
then stay as they were; ``--only k1`` so re-times the ring kernel alone:
every family's K1 points at N ≥ 256 and the clusters of every ring plan
the card runs at once, one tile a cluster or two (:func:`ring_resident`).
A ring plan's wave carries ``cb · pair · sms / cluster`` bootstraps.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import fused_blind_rotate as fbr
from ..ops.blind_rotate import FUSED_HEADROOM, fused_key_bytes
from ..tfhe.params import PRESETS, STAGED_PRESETS, TFHEParams, _curve
from .optimizer import (CALIBRATION, GLWE_SHAPES, DeviceProfile,
                        bootstrap_cost_us)
from .runtime_model import ROWS, SMALL_ROWS, family_key, resident_key

# The H100 SXM data sheet's dense int8 rate and memory rate.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# Evaluations a call: each of ROWS is BATCH × 8 … 1024 bootstraps.
BATCH = 8
# A family stops growing its calls once one takes longer than this.
MAX_CALL_MS = 1500.0
# The family the generic path is timed at, and its ciphertexts a call.
GENERIC_FAMILY, GENERIC_ROWS = "anchor", 64
# Bsk limbs the optimizer can pick (a dropped limb, or none).
LIMBS = (3, 4)


def families() -> dict[str, tuple[TFHEParams, bool]]:
    """name -> (params, staged): the presets, both families of each staged
    preset, the optimizer's native Kreyvium-1152 pick, and the JAX
    calibration list's p22 and p32 shapes."""
    out = {name: (PRESETS[name][0], False)
           for name in ("anchor", "p8", "p16", "aes128_p4")}
    for name in ("kreyvium_p10_staged", "p32_staged"):
        pre = STAGED_PRESETS[name]
        out[f"{name}.fam1"] = (pre.fam1, True)
        out[f"{name}.fam2"] = (pre.fam2, True)
    # the optimizer's native pick for Kreyvium-1152 at 1e-7 (K2 when its
    # 43 GB of matrices fit), the optimize(22, 26) pick measured on s9234r,
    # and the p32 preset
    out["kreyvium_native"] = (_curve(10, 642, 1, 1024, 4, 5, 7, 2), False)
    out["p22"] = (_curve(22, 738, 2, 1024, 3, 8, 8, 2), False)
    out["p32"] = (PRESETS["p32"][0], False)
    return out


def kernels(params: TFHEParams, staged: bool, free: int) -> list[str]:
    """The kernels a family is timed through: K1 for a staged family, as
    the CLI runs both; for a native one each fused kernel that serves it,
    K2 only where its matrices fit ``free`` bytes with ``FUSED_HEADROOM``
    to spare (``--orientation auto`` compares the two by these points)."""
    if staged:
        return ["fused_otf"]
    return [o for o in ("fused", "fused_otf")
            if fbr.unsupported(params, otf=o == "fused_otf") is None
            and (o == "fused_otf"
                 or fused_key_bytes(params) + FUSED_HEADROOM <= free)]


def small_families() -> dict[str, tuple[TFHEParams, bool]]:
    """name -> (params, staged) of the families K1's small-N kernel is
    timed at: ``bench --quick``'s (k=1, N=128, l=2) and the p32 quick
    bench's fam2 (k=2, N=128, l=3), the shapes of its longest launches."""
    from .. import bench
    return {"bench_quick": (bench.QUICK_PARAMS, False),
            "staged_test.fam2": (STAGED_PRESETS["staged_test"].fam2, True)}


def wide_families() -> dict[str, tuple[TFHEParams, bool]]:
    """name -> (params, staged) of the families of :func:`families` at N ≥
    256 that K1's small-tile plan serves at every limb count the optimizer
    picks: the families whose points it is timed at, and so the only ones
    whose launches it can take."""
    return {name: (params, staged)
            for name, (params, staged) in families().items()
            if params.poly_size >= fbr.K1_SLICE
            and all(fbr.k1s_clusters(params, limbs) for limbs in LIMBS)}


def fit_families() -> dict[str, tuple[TFHEParams, bool]]:
    """name -> (params, staged) of the shapes K1's small-tile plan serves,
    at both limbs the optimizer picks, at the (k, N) of
    :func:`wide_families` with an l none of them has: AES-128's family at
    that l (b = 8).  Their launches take the plan by the fit across
    families (``runtime_model.small_points``), so the card's checks hold it
    bitwise at them too."""
    import dataclasses

    aes = PRESETS["aes128_p4"][0]
    wide = list(wide_families().values())
    out = {}
    for k, N in sorted({(p.glwe_dim, p.poly_size) for p, _ in wide}):
        have = {p.bsk_level for p, _ in wide
                if (p.glwe_dim, p.poly_size) == (k, N)}
        for l in range(1, 32):
            params = dataclasses.replace(aes, glwe_dim=k, poly_size=N,
                                         bsk_level=l, bsk_base_log=8)
            if l * 8 >= 32 or not all(fbr.k1s_clusters(params, limbs)
                                      for limbs in LIMBS):
                break
            if l not in have:
                out[f"k={k} N={N} l={l}"] = (params, False)
    return out


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _executor(params: TFHEParams, orientation: str, device: torch.device,
              route: str | None = None):
    """A one-bootstrap program's executor over ``params``' keys, with the
    fast keys of ``orientation`` (None: the generic path) and K1's
    ``route`` (``FastKeys.route``)."""
    from ..frontend.lut_program import LutProgram
    from ..ops.blind_rotate import prepare_fast_keys
    from ..runtime.executor import CircuitExecutor
    from ..tfhe import generate_keys

    keys = generate_keys(params, seed=7, device=device)
    fast = (None if orientation == "generic"
            else prepare_fast_keys(keys, orientation=orientation))
    if fast is not None:
        fast.route = route
    prog = LutProgram()
    prog.output("o", prog.bootstrap(prog.input("x"), [0, 1]))
    return CircuitExecutor(prog, keys, fast_keys=fast)


def synth_level(params: TFHEParams, nb: int):
    """One level of ``nb`` identity bootstraps reading wire 0 and writing
    wire 1 (the JAX ``synth_plan``)."""
    from ..runtime.executor import LevelPlan
    from ..tfhe.pbs import build_test_vector

    tv, post = build_test_vector([0, 1], params)
    return LevelPlan(np.zeros((nb, 1), np.int32), np.ones((nb, 1), np.int32),
                     np.zeros(nb, np.int32),
                     np.tile(np.asarray(tv, np.int32), (nb, 1)),
                     np.full(nb, np.int64(post).astype(np.uint32)
                             .astype(np.int32)),
                     np.full(nb, 1, np.int32))


def time_point(ex, nb: int, v: int, reps: int = 3) -> dict:
    """A synthetic level of ``nb`` bootstraps × ``v`` evaluations through
    ``ex.step``: a warm-up call, then ``reps`` repetitions of chained
    calls, each timed with CUDA events (the host clock on the CPU), and the
    fused kernel's span in each call.  Where a kernel ran, the work around
    it is then timed alone, the same way (:func:`time_around`).  Medians
    over the repetitions, ms."""
    from ..runtime.profile import _ms, _stamp, _sync
    from ..utils import profiling

    device = ex.device
    ex.levels = [synth_level(ex.params, nb)]
    buf = torch.zeros((3, v, ex.params.big_dim + 1), dtype=torch.int32,
                      device=device)
    _sync(device)
    t0 = time.perf_counter()
    ex.step(buf, 0)
    _sync(device)
    first_ms = (time.perf_counter() - t0) * 1e3
    iters = max(1, min(8, int(200.0 / max(first_ms, 1e-3))))
    steps, kernels = [], []
    for _ in range(reps):
        with profiling.collect(stamp=lambda: _stamp(device)) as got:
            start = _stamp(device)
            for _ in range(iters):
                ex.step(buf, 0)
            end = _stamp(device)
        _sync(device)
        steps.append(_ms(start, end) / iters)
        spans = [(a, b) for launch, a, b in got.spans
                 if launch.path in profiling.KERNEL_PATHS]
        if spans:
            kernels.append(sum(_ms(a, b) for a, b in spans) / len(spans))
    out = {"nb": nb, "v": v, "rows": nb * v, "iters": iters,
           "step_ms": statistics.median(steps), "all_step_ms": steps,
           "kernel_ms": statistics.median(kernels) if kernels else None}
    if kernels:
        around = time_around(ex, buf, iters, reps)
        out.update(around_ms=statistics.median(around), all_around_ms=around)
    return out


@contextlib.contextmanager
def _without_rotations():
    """Every fused blind-rotation call of the fast bootstrap launches
    nothing and returns an uninitialised accumulator of its shape
    ([k+1, B, N] int32): a level then runs only the work around the
    kernel."""
    from ..ops import blind_rotate as br
    inner = br.blind_rotate_fused

    def left_out(b_init, a_t, test_polys, kernels, params, *args, **kw):
        return test_polys.new_empty((params.glwe_dim + 1,)
                                    + tuple(test_polys.shape))

    br.blind_rotate_fused = left_out
    try:
        yield
    finally:
        br.blind_rotate_fused = inner


def time_around(ex, buf: torch.Tensor, iters: int, reps: int) -> list[float]:
    """ms a call of ``ex``'s one level with its kernel calls left out
    (:func:`_without_rotations`), ``reps`` repetitions of ``iters`` chained
    calls: on the card the level as ``run`` executes it, a one-level CUDA
    graph captured without the kernel's node and replayed; on the CPU
    ``ex.step``.  The graph is dropped after."""
    from ..runtime.profile import _ms, _stamp, _sync

    device = buf.device
    with _without_rotations():
        if device.type == "cuda":
            graphs = ex._graphs_of([buf])
            call = graphs.replay
        else:
            def call():
                ex.step(buf, 0)
        times = []
        try:
            for _ in range(reps):
                _sync(device)
                start = _stamp(device)
                for _ in range(iters):
                    call()
                end = _stamp(device)
                _sync(device)
                times.append(_ms(start, end) / iters)
        finally:
            ex._graphs.clear()
    return times


def time_family(name: str, params: TFHEParams, device: torch.device,
                orient: str) -> list[dict]:
    """Every point of one family, through ``orient`` (K1 at N ≥ 256 on its
    ring kernel), at the launch sizes ``ROWS``."""
    from ..runtime.profile import _sync

    t0 = time.time()
    route = ("k1" if orient == "fused_otf"
             and params.poly_size >= fbr.K1_SLICE else None)
    ex = _executor(params, orient, device, route)
    _sync(device)
    print(f"# {name} ({family_key(params)}, {orient}): keys "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    out = []
    for r in ROWS:
        pt = time_point(ex, r // BATCH, BATCH)
        pt.update(family=name, key=family_key(params), kernel=orient,
                  limbs=4, **_device_plan(params, r, orient, device, route))
        out.append(pt)
        print(f"# {name} rows={r}: step {pt['step_ms']:.3f} ms, kernel "
              f"{pt['kernel_ms']:.3f} ms, around {pt['around_ms']:.4f} ms "
              f"{[round(x, 4) for x in pt['all_around_ms']]}, plan "
              f"{pt['plan']} waves "
              f"{pt['waves']}", file=sys.stderr)
        if pt["step_ms"] > MAX_CALL_MS:
            break
    del ex
    torch.cuda.empty_cache()
    return out


def _device_plan(params: TFHEParams, rows: int, orientation: str,
                 device: torch.device, route: str | None = None) -> dict:
    """The plan the kernel launches with for ``rows`` ciphertexts on the
    card (K1's on ``route``), and its waves."""
    if orientation == "fused_otf":
        plan = fbr.k1_device_plan(rows, params, device, route=route)
        fit = (fbr.k1_small_layout(plan, params)[1]
               if isinstance(plan, fbr.K1SmallPlan)
               else fbr.k1_max_clusters(plan))
    else:
        plan = fbr.device_plan(rows, params, device)
        fit = fbr.k2_max_clusters(plan)
    tiles = -(-rows // plan.cb)
    pair = plan.pair if isinstance(plan, fbr.K1Plan) else 1
    out = {"plan": list(plan), "resident": fit,
           "waves": -(-(-(-tiles // pair)) // max(1, fit))}
    if isinstance(plan, fbr.K1Plan):
        out["pair"] = pair
    return out


def time_wide(name: str, params: TFHEParams, device: torch.device,
              reps: int = 3) -> list[dict]:
    """K1's small-tile plan at ``params`` on the card, the kernel alone at
    full length (n steps, 4 limbs, operands drawn on the card), at every
    launch size of ``SMALL_ROWS`` on every tile and cluster it is built
    for: ms a launch, CUDA events over ``reps`` launches after a warm-up
    one."""
    from ..runtime.bisect import operands, timed_ms

    out = []
    for r in SMALL_ROWS:
        args = operands(params, r, seed=r)
        for cb in fbr.K1S_WIDE_TILES:
            for c in fbr.k1s_clusters(params, fbr.N_LIMBS, cb):
                def call(cb=cb, c=c):
                    return fbr.blind_rotate_k1(*args, params, batch_tile=cb,
                                               cluster=c, route="k1s")
                call()
                ms = timed_ms(call, reps)
                plan = fbr.k1_device_plan(r, params, device, cb=cb,
                                          cluster=c, route="k1s")
                fit = fbr.k1_small_layout(plan, params)[1]
                out.append({"family": name, "key": family_key(params),
                            "kernel": "k1s", "limbs": 4, "rows": r,
                            "plan": list(plan), "resident": fit,
                            "waves": -(-(-(-r // cb)) // max(1, fit)),
                            "kernel_ms": ms})
                print(f"# {name} rows={r} tile {cb} cluster {c}: kernel "
                      f"{ms:.3f} ms", file=sys.stderr)
        del args
    return out


def _kns() -> set[int]:
    """(k+1)·N of every GLWE shape the searches walk."""
    shapes = set(GLWE_SHAPES) | {(1, 1024), (2, 512)}
    return {(k + 1) * N for k, N in shapes}


def ring_resident() -> dict[str, int]:
    """Clusters the card runs at once of every plan of K1's ring kernel:
    its tiles, widths and tiles a cluster at the limbs the optimizer picks,
    and every cluster size that splits a GLWE shape the searches walk."""
    table = {}
    for limbs in LIMBS:
        for cb in fbr.K1_TILES:
            for nw in fbr.K1_WIDTHS:
                if not fbr.k1_fits(cb, nw, limbs):
                    continue
                for c in sorted({c for kn in _kns()
                                 for c in range(1, fbr.K1_MAX_CLUSTER + 1)
                                 if kn % (c * 2 * nw) == 0}):
                    for pair in fbr.K1_PAIRS:
                        plan = fbr.K1Plan(cb, c, nw, pair)
                        table[resident_key("fused_otf", limbs, plan)] = \
                            _resident(fbr.k1_max_clusters, plan, limbs)
    return table


def resident_table(sms: int) -> dict[str, int]:
    """Clusters the card runs at once for every plan the model can choose:
    each kernel's tiles (and K1's widths and tiles a cluster) at the limbs
    the optimizer picks, and every cluster size that splits a GLWE shape
    the searches walk."""
    kns = _kns()
    table = ring_resident()
    for limbs in LIMBS:
        shell = TFHEParams(p=2, lwe_dim=1, glwe_dim=1, poly_size=1024,
                           bsk_level=1, bsk_base_log=1, ksk_level=1,
                           ksk_base_log=1, lwe_noise_std=0.0,
                           glwe_noise_std=0.0)
        for cb in fbr.K2_TILES:
            for c in sorted({c for kn in kns
                             for c in range(1, fbr.K2_MAX_CLUSTER + 1)
                             if kn % (c * fbr.K2_CHUNK) == 0}):
                plan = fbr.k2_plan(1, shell, sms, limbs, cb, c)
                table[resident_key("fused", limbs, plan)] = \
                    _resident(fbr.k2_max_clusters, plan, limbs)
    return table


def _resident(max_clusters, plan, limbs: int) -> int:
    """``max_clusters(plan, limbs)``, or 0 (no wave runs) where the card
    refuses the plan."""
    try:
        return max_clusters(plan, limbs)
    except RuntimeError as e:
        print(f"# {plan} at {limbs} limbs: {e}", file=sys.stderr)
        return 0


def _line(x, y) -> tuple[float, float]:
    """Least squares y = a + b·x, with b ≥ 0 (else a flat a)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    if len(x) >= 2 and np.ptp(x) > 0:
        (a, b), *_ = np.linalg.lstsq(np.stack([np.ones_like(x), x], 1), y,
                                     rcond=None)
        if b >= 0:
            return float(a), float(b)
    return float(y.mean()), 0.0


def _through(x, y) -> tuple[float, float]:
    """Least squares y = F + τ·x with F ≥ 0 (else through the origin)."""
    x, y = np.asarray(x, float), np.asarray(y, float)
    f, tau = _line(x, y)
    if f < 0 or tau <= 0:
        return 0.0, float((x * y).sum() / (x * x).sum())
    return f, tau


def _through_pairs(single, paired, y) -> tuple[float, float, float]:
    """Least squares of the relative error, y = F + τ·single + π·paired
    with F ≥ 0 (else through the origin): (F, τ, π / τ).  Relative, so
    that the launches of a few waves, most of a program's, are priced as
    closely as the largest."""
    a = np.stack([np.asarray(single, float), np.asarray(paired, float)], 1)
    y = np.asarray(y, float)
    a, ones = a / y[:, None], 1.0 / y[:, None]
    (f, tau, pi), *_ = np.linalg.lstsq(np.concatenate([ones, a], 1),
                                       np.ones(len(y)), rcond=None)
    if f < 0:
        f = 0.0
        (tau, pi), *_ = np.linalg.lstsq(a, np.ones(len(y)), rcond=None)
    return float(f), float(tau), float(pi / tau)


def _family_entry(pts: list[dict], sms: int) -> dict:
    """A family's kernel fit (fixed term, time a wave unit, efficiency) and
    around fit from its points.  Where the ring kernel's points take both
    schedules, a wave of clusters carrying two tiles is fitted apart: its
    time over a wave of one tile's (``pair_scale``), so that kernel = F +
    τ · (units of one-tile waves + pair_scale · units of paired waves), a
    unit ``cb · sms / cluster`` bootstraps of one tile a cluster."""
    n, k, N, l, ks_l = (int(x) for x in pts[0]["key"].split(","))
    units = [pt["waves"] * pt["plan"][0] * sms / pt["plan"][1]
             for pt in pts]
    ms = [pt["kernel_ms"] * 1e3 for pt in pts]
    paired = [pt.get("pair", 1) == 2 for pt in pts]
    pair_scale = None
    if any(paired) and not all(paired):
        fixed, tau, pair_scale = _through_pairs(
            [0.0 if p else u for u, p in zip(units, paired)],
            [u if p else 0.0 for u, p in zip(units, paired)], ms)
    else:
        fixed, tau = _through(units, ms)
    ideal = 2.0 * (n * (k + 1) ** 2 * l * N * N * 4
                   + k * N * ks_l * (n + 1) * 4) / PEAK_INT8_OPS * 1e6
    around = _line([pt["rows"] * (k * N + 1) for pt in pts],
                   [pt["around_ms"] * 1e3 for pt in pts])
    out = {"name": pts[0]["family"], "kernel": pts[0]["kernel"],
           "fixed_us": fixed, "tau_us": tau, "eff": ideal / tau,
           "around_a_us": around[0], "around_b_us": around[1]}
    if pair_scale is not None:
        out["pair_scale"] = pair_scale
    return out


def _by_family(points: list[dict]) -> dict[str, list[dict]]:
    """The points of each family and kernel, by entry key."""
    fams: dict[str, list[dict]] = {}
    for pt in points:
        fams.setdefault(f"{pt['key']}/{pt['kernel']}", []).append(pt)
    return fams


def fit(raw: dict) -> dict:
    """The calibration from the raw record (``points``, ``generic``,
    ``sms``, ``resident``, ``k2_memory``, ``card``, ``device``, and the
    small-N kernel's ``k1s_points`` where timed)."""
    sms = raw["sms"]
    per_kernel: dict[str, list] = {"fused": [], "fused_otf": []}
    entries = {}
    for key, pts in _by_family(raw["points"]).items():
        entries[key] = _family_entry(pts, sms)
        per_kernel[entries[key]["kernel"]].append(entries[key])
    kernels = {kern: {"eff": statistics.median(e["eff"] for e in es),
                      "fixed_us": statistics.median(e["fixed_us"]
                                                    for e in es),
                      "families": sorted(e["name"] for e in es)}
               for kern, es in per_kernel.items() if es}
    # the ring's paired waves, for the families without their own entry
    scales = [e["pair_scale"] for e in per_kernel["fused_otf"]
              if "pair_scale" in e]
    if scales:
        kernels["fused_otf"]["pair_scale"] = statistics.median(scales)
    # a kernel no family was timed through takes the other's fit
    for kern, other in (("fused", "fused_otf"), ("fused_otf", "fused")):
        kernels.setdefault(kern, dict(kernels[other], families=[]))
    xs, ys = [], []
    for pt in raw["points"]:
        _, k, N, *_ = (int(x) for x in pt["key"].split(","))
        xs.append(pt["rows"] * (k * N + 1))
        ys.append(pt["around_ms"] * 1e3)
    a, b = _line(xs, ys)
    profile = DeviceProfile(
        name="h100", int8_ops=PEAK_INT8_OPS, mem_bytes=PEAK_BYTES,
        eff_fused=kernels["fused"]["eff"],
        eff_otf=kernels["fused_otf"]["eff"], k2_memory=raw["k2_memory"],
        k2_headroom=FUSED_HEADROOM, generic_slowdown=1.0)
    # the small-N K1's families: their own entries and the kernel-wide
    # ``k1s`` fit, apart from the ring kernels' fits above
    small = {key: _family_entry(pts, sms)
             for key, pts in _by_family(raw.get("k1s_points", [])).items()}
    entries.update(small)
    for key, e in entries.items():
        n, k, N, l, ks_l = (int(x) for x in key.split("/")[0].split(","))
        e["scale"] = e["tau_us"] / bootstrap_cost_us(
            n, k, N, l, ks_l, 4, profile, e["kernel"])
    # K1's points at N >= 256 (its ring kernel's), which the small-tile
    # plan's are set against at the same launch size
    for key, pts in _by_family(raw["points"]).items():
        if key.endswith("/fused_otf") and int(key.split(",")[2]) \
                >= fbr.K1_SLICE:
            entries[key]["points"] = sorted(
                [pt["rows"], pt["kernel_ms"] * 1e3] for pt in pts)
    wide, fit_wide = _fit_wide(raw.get("k1s_wide_plans", []), profile)
    entries.update(wide)
    if fit_wide:
        kernels["k1s_wide"] = fit_wide
    if small:
        es = list(small.values())
        kernels["k1s"] = {
            "eff": statistics.median(e["eff"] for e in es),
            "fixed_us": statistics.median(e["fixed_us"] for e in es),
            "scale": statistics.median(e["scale"] for e in es),
            "families": sorted(e["name"] for e in es)}
    # the generic path's time a bootstrap over K2's roofline cost at its
    # family: a fixed kernel, so that the fit reads no other calibration
    g = raw["generic"]
    n, k, N, l, ks_l = (int(x) for x in g["key"].split(","))
    slowdown = g["step_ms"] * 1e3 / g["rows"] / bootstrap_cost_us(
        n, k, N, l, ks_l, 4, profile, "fused")
    profile_d = dict(vars(profile), generic_slowdown=slowdown)
    return {"card": raw["card"], "device": raw["device"], "sms": sms,
            "profile": profile_d, "kernels": kernels,
            "around": {"around_a_us": a, "around_b_us": b},
            "families": entries,
            "resident": raw["resident"], "raw": raw}


def _fit_wide(points: list[dict], profile: DeviceProfile
              ) -> tuple[dict, dict]:
    """K1's small-tile plan from its points at every tile and cluster
    (:func:`time_wide`): each family's ``.../k1s`` entry (``points``: at
    each launch size the µs of its fastest plan; ``plans``: each tile and
    cluster as ``[tile, cluster, resident, [[waves, µs], ...]]``, the µs of
    each wave count its fullest launch timed in that many waves, which
    price and pick the plan by waves), and the fit across families at each
    launch size of the fastest µs a step: at each shape timed the median
    over its families (``shapes``; a step's time depends on the shape
    alone), and across shapes step_us + scale·cost / n (cost: the per-boot
    cost at 4 limbs), by least squares with step_us ≥ 0 (:func:`_through`),
    which holds at the (k, N) timed (``rings``)."""
    best: dict[str, dict[int, float]] = {}
    waves: dict[str, dict[tuple, tuple]] = {}
    names = {}
    for pt in points:
        key = f"{pt['key']}/k1s"
        us = pt["kernel_ms"] * 1e3
        fam = best.setdefault(key, {})
        fam[pt["rows"]] = min(us, fam.get(pt["rows"], us))
        names[key] = pt["family"]
        _, by_waves = waves.setdefault(key, {}).setdefault(
            tuple(pt["plan"][:2]), (pt["resident"], {}))
        if pt["rows"] > by_waves.get(pt["waves"], (0, 0.0))[0]:
            by_waves[pt["waves"]] = (pt["rows"], us)
    entries = {key: {"name": names[key], "kernel": "k1s",
                     "points": sorted([r, us] for r, us in fam.items()),
                     "plans": [[*plan, resident, sorted(
                         [w, us] for w, (_, us) in by_waves.items())]
                         for plan, (resident, by_waves)
                         in sorted(waves[key].items())]}
               for key, fam in best.items()}
    if len(entries) < 2:
        return entries, {}
    rows = sorted(set.intersection(*(set(f) for f in best.values())))
    steps, costs = [], []
    for key in best:
        n, k, N, l, ks_l = (int(x) for x in key.split("/")[0].split(","))
        steps.append(n)
        costs.append(bootstrap_cost_us(n, k, N, l, ks_l, 4, profile,
                                       "fused_otf") / n)
    step, scale = [], []
    for r in rows:
        f, tau = _through(costs, [fam[r] / n for fam, n in zip(
            best.values(), steps)])
        step.append(f)
        scale.append(tau)
    by_shape: dict[str, list] = {}
    for (key, fam), n in zip(best.items(), steps):
        _, k, N, l, _ = (int(x) for x in key.split("/")[0].split(","))
        by_shape.setdefault(f"{k + 1}x{N}x{l}", []).append(
            [fam[r] / n for r in rows])
    shapes = {shape: [statistics.median(col) for col in zip(*fams)]
              for shape, fams in by_shape.items()}
    rings = sorted({tuple(int(x) for x in key.split(",")[1:3])
                    for key in best})
    return entries, {"rows": rows, "step_us": step, "scale": scale,
                            "shapes": shapes, "rings": [list(r) for r in
                                                        rings],
                            "families": sorted(names.values())}


def measure(device: torch.device) -> dict:
    """Time every family, the small-N kernel's (:func:`measure_small`) and
    the generic path on the card."""
    from ..runtime.cli import free_memory

    fams = families()
    free = free_memory(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t0 = time.time()
    resident = resident_table(sms)
    print(f"# resident table: {len(resident)} plans, "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    points = []
    for name, (params, staged) in fams.items():
        for orient in kernels(params, staged, free):
            points += time_family(name, params, device, orient)
    params = fams[GENERIC_FAMILY][0]
    ex = _executor(params, "generic", device)
    generic = time_point(ex, GENERIC_ROWS // BATCH, BATCH, reps=2)
    generic.update(family=GENERIC_FAMILY, key=family_key(params),
                   kernel="generic")
    print(f"# generic {GENERIC_FAMILY} rows={GENERIC_ROWS}: "
          f"{generic['step_ms']:.1f} ms", file=sys.stderr)
    small, wide, small_resident = measure_small(device)
    return {"card": card(), "device": torch.cuda.get_device_name(device),
            "torch": torch.__version__, "sms": sms, "k2_memory": free,
            "resident": {**resident, **small_resident}, "points": points,
            "generic": generic, "k1s_points": small,
            "k1s_wide_plans": wide, "k1s_card": card()}


def _ring_point(pt: dict) -> bool:
    """Whether a raw point is of K1's ring kernel (K1 at N ≥ 256)."""
    return (pt["kernel"] == "fused_otf"
            and int(pt["key"].split(",")[2]) >= fbr.K1_SLICE)


def measure_ring(device: torch.device, points: list[dict]) -> list[dict]:
    """``points`` with every point of K1's ring kernel timed anew on the
    card, each family's where its old ones were."""
    from ..runtime.cli import free_memory

    free = free_memory(device)
    fresh = {}
    for name, (params, staged) in families().items():
        if (params.poly_size >= fbr.K1_SLICE
                and "fused_otf" in kernels(params, staged, free)):
            fresh[family_key(params)] = time_family(name, params, device,
                                                    "fused_otf")
    out, done = [], set()
    for pt in points:
        if not _ring_point(pt):
            out.append(pt)
        elif pt["key"] not in done:
            done.add(pt["key"])
            out += fresh.pop(pt["key"], [])
    return out + [pt for pts in fresh.values() for pt in pts]


def measure_small(device: torch.device
                  ) -> tuple[list[dict], list[dict], dict]:
    """Time K1's small-N kernel at every family of :func:`small_families`
    (through ``fused_otf``, as the CLI runs N < 256 there) and its
    small-tile plan at every family of :func:`wide_families`
    (:func:`time_wide`); the two lists of points, and the clusters the card
    runs at once of each plan they launched (at N ≥ 256 of every tile and
    cluster the plan may take, :func:`wide_resident`), at every limb count
    the optimizer picks."""
    points, wide, resident = [], [], {}
    for name, (params, _) in small_families().items():
        pts = time_family(name, params, device, "fused_otf")
        points += pts
        for pt in pts:
            for limbs in LIMBS:
                plan = fbr.k1_device_plan(pt["rows"], params, device, limbs)
                resident[resident_key("fused_otf", limbs, plan, params)] = \
                    fbr.k1_small_layout(plan, params, limbs)[1]
    for name, (params, _) in wide_families().items():
        wide += time_wide(name, params, device)
    return points, wide, {**resident, **wide_resident()}


def wide_resident() -> dict[str, int]:
    """The clusters the card runs at once of every tile and cluster of K1's
    small-tile plan at the families of :func:`wide_families` and
    :func:`fit_families`, at every limb count the optimizer picks."""
    resident = {}
    for params, _ in {**wide_families(), **fit_families()}.values():
        for limbs in LIMBS:
            for cb in fbr.K1S_WIDE_TILES:
                for c in fbr.k1s_clusters(params, limbs, cb):
                    plan = fbr.k1_wide_plan(1, params, 132, limbs, c, cb=cb)
                    resident[resident_key("fused_otf", limbs, plan,
                                          params)] = \
                        fbr.k1_small_layout(plan, params, limbs)[1]
    return resident


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry", action="store_true",
                    help="refit from the raw points of the existing file")
    ap.add_argument("--only", choices=("k1s", "k1"), default=None,
                    help="time only K1's small-N kernel (k1s) or its ring "
                         "kernel (k1) and put its points in the existing "
                         "file")
    ap.add_argument("--out", default=str(CALIBRATION))
    args = ap.parse_args(argv)

    if args.dry:
        with open(args.out) as f:
            raw = json.load(f)["raw"]
    elif args.only == "k1s":
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device; the calibration is measured "
                  "on the card", file=sys.stderr)
            return 2
        with open(CALIBRATION) as f:
            raw = json.load(f)["raw"]
        device = torch.device("cuda")
        points, wide, resident = measure_small(device)
        raw["k1s_points"] = points
        raw.pop("k1s_wide_points", None)
        raw["k1s_wide_plans"] = wide
        raw["k1s_card"] = card()
        raw["resident"] = {**raw["resident"], **resident}
    elif args.only == "k1":
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device; the calibration is measured "
                  "on the card", file=sys.stderr)
            return 2
        with open(CALIBRATION) as f:
            raw = json.load(f)["raw"]
        raw["points"] = measure_ring(torch.device("cuda"), raw["points"])
        raw["resident"] = {**raw["resident"], **ring_resident()}
        raw["k1_card"] = card()
    else:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device; the calibration is measured "
                  "on the card", file=sys.stderr)
            return 2
        raw = measure(torch.device("cuda"))
    cal = fit(raw)
    with open(args.out, "w") as f:
        json.dump(cal, f, indent=1)
        f.write("\n")
    print(json.dumps({k: cal[k] for k in ("card", "sms", "profile",
                                          "kernels", "around")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
