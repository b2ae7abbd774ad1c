"""Where the time of a homomorphic run goes, level by level.

    python -m tfhe_fbs_map_tpu_torch.runtime.profile prog.lbf \\
        --params aes128_p4 --batch 8 --orientation fused_otf \\
        [--levels 40] [--trace-levels 40] [--tile-sweep] [--out prof.json]

Runs the program's levels one at a time through ``CircuitExecutor.step``,
as ``CircuitExecutor.run`` does with a checkpoint (without one it replays
a CUDA graph a level group, which hides the levels), and times every level
and every fused blind-rotation call inside it (CUDA events on the card,
the host clock on the CPU, paired with the calls' entries of the launch
record, ``utils.profiling``), grouped by ciphertexts a level and, for each
parameter family (``fam1``/``fam2`` of a staged preset, ``native``
otherwise), by ciphertexts a launch.  When every level ran it decrypts and checks the
outputs against ``LutProgram.eval``.  It then runs the first
``--trace-levels`` levels again under ``torch.profiler``: the device's busy
time, its idle share between the first and the last kernel, and the
kernels with the most device time.  ``--tile-sweep`` (CUDA only) times the
kernel at the most common launch shape (fam1's for a staged preset) over
its launch knobs: K1's (ciphertexts per tile, CTAs per cluster,
coefficients per warpgroup, tiles a cluster) and K2's (ciphertexts per
tile, CTAs per cluster) plans; every setting's output must be the same.  Prints one JSON
object as its last line.

    python -m tfhe_fbs_map_tpu_torch.runtime.profile --step-variants \\
        [--batch 512] [--steps 64] [--iters 4]

times the ``"matmul"`` orientation's CMux step in pieces instead, the port
of ``experiments/profile_step.py``: at the bench anchor's shapes (k=2,
N=512, l=2, b=8, four key limbs; random keys, ``--steps`` of them) the
variants ``full`` (rotation, digits, the int8 product, the limb combine:
:func:`..ops.blind_rotate.cmux_partial`), ``rot_only``, ``mm_only`` (the
product and the combine of fixed digits), ``dec_only`` (the step's
digits and a sum) and ``mm_rot`` (rotation and product, no digits), and beside JAX's
five ``int_mm``, the ``torch._int_mm`` call alone; each one JSON line with
µs a step and the boots/s it implies at the anchor's n=546.  On the card
a variant is timed as the replay of a CUDA graph of its ``--steps`` steps
(JAX times one jitted scan), its eager time beside it; ``mm_only`` × n is
the library time of the launch's contractions with their limb combine,
``int_mm`` × n of the products alone.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from ..tfhe.params import StagedPreset
from ..utils import profiling
from .executor import CircuitExecutor

__all__ = ["profile_program", "trace_run", "step_variants", "VARIANTS"]

# experiments/profile_step.py's five, then the product alone
VARIANTS = ("full", "rot_only", "mm_only", "dec_only", "mm_rot", "int_mm")


def _stamp(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, torch.cuda.Event):
        return a.elapsed_time(b)
    return (b - a) * 1e3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_levels(ex: CircuitExecutor, buf: torch.Tensor,
                levels: int) -> tuple[torch.Tensor, dict]:
    """Run the first ``levels`` levels on a copy of ``buf``; per-level times
    grouped by ciphertexts a level, and per-launch times by family and
    ciphertexts a launch: the launch record's entries of the level's
    family calls, each with its blind rotation's stamps
    (:func:`..utils.profiling.collect`)."""
    device = ex.device
    buf = buf.clone()
    stamps = []
    _sync(device)
    t0 = time.perf_counter()
    with profiling.collect(stamp=lambda: _stamp(device)) as got:
        for lv in range(levels):
            start, first = _stamp(device), len(got.spans)
            buf = ex.step(buf, lv)
            stamps.append((start, _stamp(device), first, len(got.spans)))
    _sync(device)
    wall = time.perf_counter() - t0
    groups = defaultdict(lambda: [0, 0.0, 0.0])
    fams = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    level_ms = kernel_ms = 0.0
    for a, b, lo, hi in stamps:
        launches = [(launch.family, launch.launched, _ms(ka, kb))
                    for launch, ka, kb in got.spans[lo:hi]]
        g = groups[sum(w for _, w, _ in launches)]
        g[0] += 1
        g[1] += _ms(a, b)
        g[2] += sum(ms for *_, ms in launches)
        level_ms += _ms(a, b)
        kernel_ms += sum(ms for *_, ms in launches)
        for fam, width, ms in launches:
            f = fams[fam][width]
            f[0] += 1
            f[1] += ms
    return buf, {
        "levels": levels,
        "wall_s": wall,
        "sum_level_ms": level_ms,
        "sum_kernel_ms": kernel_ms,
        "kernel_share_of_wall": kernel_ms / (wall * 1e3) if wall else None,
        "by_ciphertexts_per_launch": {
            str(w): {"levels": n, "level_ms_mean": lms / n,
                     "kernel_ms_mean": kms / n}
            for w, (n, lms, kms) in sorted(groups.items())},
        "by_family": {
            fam: {"launches": sum(n for n, _ in ws.values()),
                  "kernel_ms": sum(ms for _, ms in ws.values()),
                  "by_ciphertexts_per_launch": {
                      str(w): {"launches": n, "kernel_ms_mean": ms / n}
                      for w, (n, ms) in sorted(ws.items())}}
            for fam, ws in sorted(fams.items())},
    }


def trace_run(device: torch.device, fn, top: int = 12) -> dict:
    """``fn()`` under ``torch.profiler``, synchronized: its wall seconds
    (the profiler's start and stop left out), the device's busy time (union of kernel spans), its idle share between
    the first and the last kernel, and the kernels with the most device
    time.  Device numbers are None where the profiler recorded no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # only the device's activity is read; on the card the host's events
    # would only slow the trace down
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    res = {"wall_s": wall, "device_events": len(kernels), "busy_s": None,
           "idle_share": None, "first_span_to_last_s": None,
           "top_kernels_ms": []}
    if not kernels:
        return res
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    per_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        agg = per_name[e.name[:60]]
        agg[0] += (e.time_range.end - e.time_range.start) / 1e3
        agg[1] += 1
    res.update(busy_s=busy / 1e6, idle_share=1 - busy / window,
               first_span_to_last_s=window / 1e6,
               top_kernels_ms=sorted(([n, ms, c] for n, (ms, c)
                                      in per_name.items()),
                                     key=lambda r: -r[1])[:top])
    return res


def trace_levels(ex: CircuitExecutor, buf: torch.Tensor, levels: int,
                 top: int = 12) -> dict:
    """The first ``levels`` levels, stepped one by one, under
    ``torch.profiler`` (:func:`trace_run`)."""
    buf = buf.clone()

    def walk():
        for lv in range(levels):
            ex.step(buf, lv)
    return {"window_levels": levels, **trace_run(ex.device, walk, top)}


def tile_sweep(fast, batch: int, reps: int = 2) -> dict:
    """The kernel of the fast keys ``fast`` at ``batch`` ciphertexts over
    its launch knobs: every K1 (tile, cluster, warpgroup width) or K2 (tile,
    cluster) plan; below N=256, and where the cost model sends K1 to its
    small-tile plan at N = 512 (``runtime_model.launch_choice``), every
    cluster that kernel is built for at the plan's tile.  ms per launch
    (CUDA events, after a warm-up launch); every setting's output must
    equal the first one's."""
    from ..ops import fused_blind_rotate as fbr
    from ..optimizer.runtime_model import launch_choice

    params, kern = fast.params, fast.bsk_kernels
    dev = kern.device
    otf = fast.orientation == "fused_otf"
    n, N = params.lwe_dim, params.poly_size
    g = torch.Generator(device=dev).manual_seed(11)
    b_init = torch.randint(0, 2 * N, (batch, 1), generator=g, device=dev,
                           dtype=torch.int32)
    a_t = torch.randint(0, 2 * N, (n, batch, 1), generator=g, device=dev,
                        dtype=torch.int32)
    tvs = torch.randint(-2 ** 31, 2 ** 31, (batch, N), generator=g,
                        device=dev, dtype=torch.int32)
    if otf:
        limbs = fast.limbs
        choice = launch_choice(params, batch, 1, "fused_otf", limbs,
                               fast.route)
        plan = fbr.k1_device_plan(batch, params, dev, limbs,
                                  *(choice.tile or (None, None)),
                                  route=choice.route)
        if isinstance(plan, fbr.K1SmallPlan):
            # the small-N kernel's knob: its clusters at the plan's tile
            knobs = {f"{plan.cb}x{c}": dict(batch_tile=plan.cb, cluster=c,
                                            route=choice.route)
                     for c in fbr.k1s_clusters(params, limbs, plan.cb)}
            default = f"{plan.cb}x{plan.cluster}"
        else:
            # the ring's knobs, one tile a cluster or two (" pair")
            knobs = {f"{cb}x{c}/{w}{' pair' * (pr == 2)}": dict(
                batch_tile=cb, cluster=c, nw=w, pair=pr)
                for cb in fbr.K1_TILES for w in fbr.K1_WIDTHS
                if fbr.k1_fits(cb, w, limbs)
                for c in fbr.k1_clusters(params, w) for pr in fbr.K1_PAIRS}
            default = (f"{plan.cb}x{plan.cluster}/{plan.nw}"
                       f"{' pair' * (plan.pair == 2)}")
    else:
        knobs = {f"{cb}x{c}": dict(batch_tile=cb, cluster=c)
                 for cb in fbr.K2_TILES for c in fbr.k2_clusters(params)}
        plan = fbr.device_plan(batch, params, dev)
        default = f"{plan.cb}x{plan.cluster}"
    fn = fbr.blind_rotate_k1 if otf else fbr.blind_rotate_k2
    keys = {"hankel": fast.hankel} if otf else {}  # the ring's table, once
    res, first = {}, None
    for name, kw in knobs.items():
        def call():
            return fn(b_init, a_t, tvs, kern, params, **kw, **keys)
        out = call()
        torch.cuda.synchronize(dev)
        if first is None:
            first = out
        elif not torch.equal(out, first):
            raise RuntimeError(f"launch knobs {name} change the output")
        start = _stamp(dev)
        for _ in range(reps):
            call()
        end = _stamp(dev)
        torch.cuda.synchronize(dev)
        tile = kw["batch_tile"]
        ctas = (-(-(-(-batch // tile)) // kw.get("pair", 1))
                * kw.get("cluster", 1))
        res[name] = {"ctas": ctas, "ms": _ms(start, end) / reps}
    return {"ciphertexts": batch, "default": default, "by_knobs": res}


def profile_program(prog, params, batch: int, orientation: str,
                    device: torch.device, levels: int | None = None,
                    trace: int = 0, sweep: bool = False,
                    seed: int = 42) -> dict:
    """Keys, fast keys and inputs as the runtime CLI makes them (``params``:
    one family's :class:`TFHEParams` or a :class:`StagedPreset`, whose
    families both take ``orientation``), then the timed level loop, the
    traced window and the tile sweep."""
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe import generate_keys
    from ..tfhe.staged import generate_staged_keys

    if isinstance(params, StagedPreset):
        keys = generate_staged_keys(params.p, params.fam1, params.fam2,
                                    seed=seed, device=device)
        fast = tuple(prepare_fast_keys(k, orientation=orientation)
                     for k in (keys.keys1, keys.keys2))
    else:
        keys = generate_keys(params, seed=seed, device=device)
        fast = prepare_fast_keys(keys, orientation=orientation)
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    rng = np.random.default_rng(seed)
    names = [n.name for n in prog.nodes if n.kind == "input"]
    values = {name: rng.integers(0, 2, batch) for name in names}
    buf0 = ex.encrypt_inputs(values, rng)
    total = len(ex.levels)
    levels = total if levels is None else min(levels, total)

    out = {"orientation": orientation, "staged": ex.staged, "batch": batch,
           "bootstraps": ex.num_bootstraps, "program_levels": total}
    buf, out["events"] = time_levels(ex, buf0, levels)
    if levels == total:
        got = ex.decrypt_outputs(buf)
        out["events"]["bit_exact"] = all(
            np.array_equal(np.asarray(want), got[k])
            for k, want in prog.eval(values).items())
    if trace:
        out["profile"] = trace_levels(ex, buf0, min(trace, total))
    if sweep and device.type == "cuda":
        # the fam1 call of a staged level, else the level's one call
        sweep_fast = fast[0] if ex.staged else fast
        widths = Counter(int(p.arrays()[0].shape[0]) * batch
                         for p in ex.levels if p.arrays()[0].shape[0])
        out["tile_sweep"] = tile_sweep(sweep_fast,
                                       widths.most_common(1)[0][0])
    return out


def step_variants(device: torch.device, batch: int = 512, steps: int = 64,
                  iters: int = 4, params=None, seed: int = 0) -> list[dict]:
    """Each of :data:`VARIANTS` run over ``steps`` CMux steps of
    ``params`` (default the bench anchor, ``PRESETS["anchor"]``) on
    random operands, ``iters`` times: one dict a variant with µs a step
    (on CUDA a CUDA graph's replay, ``eager_us_per_step`` beside it; on the
    CPU the host clock), that times the anchor's n (``ms_per_launch``), ms
    a bootstrap and the boots/s they imply."""
    from ..ops.blind_rotate import (FastKeys, N_LIMBS, key_product, rotate,
                                    step_digits)
    from ..tfhe.numeric import I32, I64, int8_matmul_nt, wrap32
    from ..tfhe.params import PRESETS

    params = params or PRESETS["anchor"][0]
    n_boot = params.lwe_dim
    k1, N, l = params.glwe_dim + 1, params.poly_size, params.bsk_level
    t_len = k1 * l * N
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=device,
                             dtype=torch.int64).to(dtype)

    kern = torch.randint(-128, 128, (steps, N_LIMBS * k1 * N, t_len),
                         generator=g, device=device, dtype=torch.int8)
    fast = FastKeys(params, kern, torch.zeros(8, 8, dtype=torch.int8,
                                              device=device), "matmul")
    acc0 = ints(-2 ** 31, 2 ** 31, (batch, k1, N), I32)
    a_t = ints(0, 2 * N, (steps, batch), I32)
    digits_fix = ints(-128, 128, (batch, t_len), torch.int8)

    def add(acc, x):
        return wrap32(acc.to(I64) + x.to(I64).view(acc.shape))

    def step(name: str, acc, i: int):
        if name == "full":
            diff = rotate(acc, a_t[i]) - acc.to(I64)
            return add(acc, key_product(step_digits(diff, params), fast, i))
        if name == "rot_only":
            return wrap32(rotate(acc, a_t[i]) + 1)
        if name == "mm_only":
            return add(acc, key_product(digits_fix, fast, i))
        if name == "int_mm":
            int8_matmul_nt(digits_fix, kern[i])
            return acc
        if name == "dec_only":
            d = step_digits(acc, params).view(batch, k1, l, N)
            return add(acc, d.to(I64).sum(2))
        # mm_rot: the rotated difference itself as int8 digits, twice
        diff = (rotate(acc, a_t[i]) - acc.to(I64)).to(torch.int8)
        flat = diff.reshape(batch, k1 * N).repeat(1, t_len // (k1 * N))
        return add(acc, key_product(flat, fast, i))

    def scan(name: str, acc):
        for i in range(steps):
            acc = step(name, acc, i)
        return acc

    out = []
    for name in VARIANTS:
        if device.type == "cuda":
            static = acc0.clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                scan(name, static)                    # warm-up
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                static.copy_(scan(name, static))
            graph.replay()
            t0 = _stamp(device)
            for _ in range(iters):
                graph.replay()
            t1 = _stamp(device)
            _sync(device)
            us = _ms(t0, t1) * 1e3 / (iters * steps)
            e0 = _stamp(device)
            acc = acc0
            for _ in range(iters):
                acc = scan(name, acc)
            e1 = _stamp(device)
            _sync(device)
            eager = _ms(e0, e1) * 1e3 / (iters * steps)
            del graph, static
        else:
            scan(name, acc0)                          # warm-up
            t0 = _stamp(device)
            acc = acc0
            for _ in range(iters):
                acc = scan(name, acc)
            us = _ms(t0, _stamp(device)) * 1e3 / (iters * steps)
            eager = us
        out.append({
            "variant": name, "us_per_step": round(us, 3),
            "eager_us_per_step": round(eager, 3), "batch": batch,
            "steps": steps, "n": n_boot,
            "ms_per_launch": round(us * n_boot / 1e3, 4),
            "ms_per_boot": round(us * n_boot / 1e3 / batch, 6),
            "implied_boots_per_s": round(batch / (us * n_boot / 1e6), 1)})
    return out


def main(argv=None) -> int:
    from ..frontend.lut_program import parse_lbf
    from ..tfhe.params import PRESETS, STAGED_PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("filename", nargs="?", help=".lbf program")
    ap.add_argument("--params", choices=sorted(PRESETS) + sorted(
        STAGED_PRESETS), default="test",
        help="a one-family preset, or a staged one (two families)")
    ap.add_argument("--batch", type=int, default=None,
                    help="evaluations (default 8), or with --step-variants "
                         "ciphertexts (default 512)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--orientation", default="fused_otf",
                    choices=["fused", "fused_otf"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--levels", type=int, default=None,
                    help="time only the first levels (default: all)")
    ap.add_argument("--trace-levels", type=int, default=40,
                    help="levels run under torch.profiler (0: none)")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="time the kernel at every launch plan (CUDA)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--step-variants", action="store_true",
                    help="time the matmul orientation's CMux step in "
                         "pieces at the bench's shapes (no program)")
    ap.add_argument("--steps", type=int, default=64,
                    help="--step-variants: steps a timed scan")
    ap.add_argument("--iters", type=int, default=4,
                    help="--step-variants: timed scans a variant")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if args.step_variants:
        for res in step_variants(device, args.batch or 512, args.steps,
                                 args.iters):
            if device.type == "cuda":
                res["device"] = torch.cuda.get_device_name(device)
            print(json.dumps(res), flush=True)
        return 0
    if args.filename is None:
        ap.error("a program (.lbf) or --step-variants")
    with open(args.filename) as f:
        prog = parse_lbf(f.read())
    params = (STAGED_PRESETS[args.params] if args.params in STAGED_PRESETS
              else PRESETS[args.params][0])
    res = profile_program(prog, params, args.batch or 8, args.orientation,
                          device, args.levels, args.trace_levels,
                          args.tile_sweep, args.seed)
    if device.type == "cuda":
        res["device"] = torch.cuda.get_device_name(device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0 if res["events"].get("bit_exact", True) else 1


if __name__ == "__main__":
    sys.exit(main())
