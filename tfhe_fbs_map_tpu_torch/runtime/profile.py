"""Where the time of a homomorphic run goes, level by level.

    python -m tfhe_fbs_map_tpu_torch.runtime.profile prog.lbf \\
        --params aes128_p4 --batch 8 --orientation fused_otf \\
        [--levels 40] [--trace-levels 40] [--tile-sweep] [--out prof.json]

Runs the program's levels one at a time, as ``CircuitExecutor.run`` does,
and times every level and the fused blind-rotation call inside it (CUDA
events on the card, the host clock on the CPU), grouped by ciphertexts per
launch.  When every level ran it decrypts and checks the outputs against
``LutProgram.eval``.  It then runs the first ``--trace-levels`` levels again
under ``torch.profiler``: the device's busy time, its idle share between the
first and the last kernel, and the kernels with the most device time.
``--tile-sweep`` (CUDA only) times the kernel at the most common level shape
over its launch knobs: K1's (ciphertexts per tile, CTAs per cluster,
coefficients per warpgroup) and K2's (ciphertexts per tile, CTAs per
cluster) plans; every setting's output must be the same.  Prints one JSON
object as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import Counter, defaultdict

import numpy as np
import torch

from .executor import CircuitExecutor, _level_step

__all__ = ["profile_program"]


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


@contextlib.contextmanager
def _timed_rotations(device: torch.device, spans: list):
    """Stamp both sides of every fused blind-rotation call of the fast
    bootstrap; ``spans`` collects (start, end) pairs."""
    from ..ops import blind_rotate as br
    inner = br.blind_rotate_fused

    def timed(*args, **kw):
        t0 = _stamp(device)
        out = inner(*args, **kw)
        spans.append((t0, _stamp(device)))
        return out

    br.blind_rotate_fused = timed
    try:
        yield
    finally:
        br.blind_rotate_fused = inner


def time_levels(ex: CircuitExecutor, buf: torch.Tensor,
                levels: int) -> tuple[torch.Tensor, dict]:
    """Run the first ``levels`` levels on a copy of ``buf``; per-level and
    per-launch times grouped by ciphertexts per launch."""
    device, plans = ex.device, ex.plan_tensors()
    buf = buf.clone()
    stamps, spans = [], []
    _sync(device)
    t0 = time.perf_counter()
    with _timed_rotations(device, spans):
        for lv in range(levels):
            start = _stamp(device)
            buf = _level_step(ex.keys, ex.fast_keys, buf, *plans[lv])
            stamps.append((start, _stamp(device)))
    _sync(device)
    wall = time.perf_counter() - t0
    groups = defaultdict(lambda: [0, 0.0, 0.0])
    level_ms = kernel_ms = 0.0
    for lv, ((a, b), (ka, kb)) in enumerate(zip(stamps, spans)):
        width = int(plans[lv][0].shape[0]) * buf.shape[1]
        g = groups[width]
        g[0] += 1
        g[1] += _ms(a, b)
        g[2] += _ms(ka, kb)
        level_ms += _ms(a, b)
        kernel_ms += _ms(ka, kb)
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
    }


def trace_levels(ex: CircuitExecutor, buf: torch.Tensor, levels: int,
                 top: int = 12) -> dict:
    """The first ``levels`` levels under ``torch.profiler``: device busy
    time (union of kernel spans), idle share between the first and the last
    kernel, and the kernels with the most device time.  Device numbers are
    None where the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device, plans = ex.device, ex.plan_tensors()
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    buf = buf.clone()
    _sync(device)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        for lv in range(levels):
            buf = _level_step(ex.keys, ex.fast_keys, buf, *plans[lv])
        _sync(device)
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    res = {"window_levels": levels, "wall_s": wall,
           "device_events": len(kernels), "busy_s": None, "idle_share": None,
           "first_span_to_last_s": None, "top_kernels_ms": []}
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


def tile_sweep(ex: CircuitExecutor, batch: int, reps: int = 2) -> dict:
    """The fast keys' kernel at ``batch`` ciphertexts over its launch
    knobs: every K1 (tile, cluster, warpgroup width) or K2 (tile, cluster)
    plan.  ms per launch (CUDA events, after a warm-up launch);
    every setting's output must equal the first one's."""
    from ..ops import fused_blind_rotate as fbr

    params, dev = ex.params, ex.device
    otf = ex.fast_keys.orientation == "fused_otf"
    kern = ex.fast_keys.bsk_kernels
    n, N = params.lwe_dim, params.poly_size
    g = torch.Generator(device=dev).manual_seed(11)
    b_init = torch.randint(0, 2 * N, (batch, 1), generator=g, device=dev,
                           dtype=torch.int32)
    a_t = torch.randint(0, 2 * N, (n, batch, 1), generator=g, device=dev,
                        dtype=torch.int32)
    tvs = torch.randint(-2 ** 31, 2 ** 31, (batch, N), generator=g,
                        device=dev, dtype=torch.int32)
    if otf:
        limbs = kern.shape[1] // (params.glwe_dim + 1)
        knobs = {f"{cb}x{c}/{w}": dict(batch_tile=cb, cluster=c, nw=w)
                 for cb in fbr.K1_TILES for w in fbr.K1_WIDTHS
                 if fbr.k1_fits(cb, w, limbs)
                 for c in fbr.k1_clusters(params, w)}
        plan = fbr.k1_device_plan(batch, params, dev, limbs)
        default = f"{plan.cb}x{plan.cluster}/{plan.nw}"
    else:
        knobs = {f"{cb}x{c}": dict(batch_tile=cb, cluster=c)
                 for cb in fbr.K2_TILES for c in fbr.k2_clusters(params)}
        plan = fbr.device_plan(batch, params, dev)
        default = f"{plan.cb}x{plan.cluster}"
    fn = fbr.blind_rotate_k1 if otf else fbr.blind_rotate_k2
    res, first = {}, None
    for name, kw in knobs.items():
        def call():
            return fn(b_init, a_t, tvs, kern, params, **kw)
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
        ctas = -(-batch // tile) * kw.get("cluster", 1)
        res[name] = {"ctas": ctas, "ms": _ms(start, end) / reps}
    return {"ciphertexts": batch, "default": default, "by_knobs": res}


def profile_program(prog, params, batch: int, orientation: str,
                    device: torch.device, levels: int | None = None,
                    trace: int = 0, sweep: bool = False,
                    seed: int = 42) -> dict:
    """Keys, fast keys and inputs as the runtime CLI makes them, then the
    timed level loop, the traced window and the tile sweep."""
    from ..ops.blind_rotate import prepare_fast_keys
    from ..tfhe import generate_keys

    keys = generate_keys(params, seed=seed, device=device)
    fast = prepare_fast_keys(keys, orientation=orientation)
    ex = CircuitExecutor(prog, keys, fast_keys=fast)
    rng = np.random.default_rng(seed)
    names = [n.name for n in prog.nodes if n.kind == "input"]
    values = {name: rng.integers(0, 2, batch) for name in names}
    buf0 = ex.encrypt_inputs(values, rng)
    total = len(ex.levels)
    levels = total if levels is None else min(levels, total)

    out = {"orientation": orientation, "batch": batch,
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
        widths = Counter(int(p.wire_idx.shape[0]) * batch for p in ex.levels)
        out["tile_sweep"] = tile_sweep(ex, widths.most_common(1)[0][0])
    return out


def main(argv=None) -> int:
    from ..frontend.lut_program import parse_lbf
    from ..tfhe.params import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("filename", help=".lbf program")
    ap.add_argument("--params", choices=sorted(PRESETS), default="test")
    ap.add_argument("--batch", type=int, default=8)
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
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    with open(args.filename) as f:
        prog = parse_lbf(f.read())
    res = profile_program(prog, PRESETS[args.params][0], args.batch,
                          args.orientation, device, args.levels,
                          args.trace_levels, args.tile_sweep, args.seed)
    if device.type == "cuda":
        res["device"] = torch.cuda.get_device_name(device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0 if res["events"].get("bit_exact", True) else 1


if __name__ == "__main__":
    sys.exit(main())
