"""Data-parallel weak-scaling study of the port.

    python -m tfhe_fbs_map_tpu_torch.harness.scaling_study --device cpu
    python -m tfhe_fbs_map_tpu_torch.harness.scaling_study --quick  # the GPUs

The port of ``experiments/scaling_study.py``.  Each point is a subprocess
of ``python -m tfhe_fbs_map_tpu_torch.bench_multichip`` at dp ∈ {1, 2, 4,
8} with a fixed ``--batch-per-chip``, ``--iters`` and ``--orientation``
(weak scaling: the ideal is a flat rate a position), and

    efficiency(n) = value(n) / (n · value(1))

is taken over the real points only:

* ``--device cpu`` is the JAX study's virtual mesh: ``--quick
  --cpu-devices n``, pinned with ``taskset`` to n host cores where n ≤ the
  host's cores (each core stands in for a chip); the other points are
  recorded as oversubscribed.
* ``--device cuda`` (the default) deals the positions over the visible
  cards (``bench_multichip --dp n``): a point with more positions than
  cards shares a card, is marked ``shared_card`` and is left out of the
  efficiency.  On one card only dp = 1 is real, and no efficiency is
  claimed.  ``--quick`` takes the tiny family (N=128, K1's small-N kernel),
  else ``bench_multichip``'s full one.

Then the multi-process points: 2 and 4 processes of
:mod:`..parallel.worker` in one gloo group, each running one dp-sharded
bootstrap on the global mesh and checking its decryptions bitwise; each
point gives ``ok``, ``errors`` and ``wall_s``.

Then JAX's two tp points: ``bench_multichip --orientation matmul`` at
dp=1 on one position (on the CPU pinned to one core) and at tp=2 on two
(two cores), the same batch a group, so the ideal is twice the rate:

    tp2_efficiency = value(tp=2) / (2 · value(tp=1))

taken where both points are real (on one card the tp=2 point shares it
and the efficiency is null; the points are kept).

Writes one JSON object with the JAX study's keys, plus ``device`` (and on
the card its name and power limit from ``nvidia-smi``), to ``--out``
(default ``outputs/h100/scaling_<device>.json``, git-ignored; never the
JAX record ``outputs/scaling_virtual.json``).  A point with decode errors,
a failed run or a failed rank makes the study exit 1 without writing it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["run_point", "run_multiprocess", "study", "main"]

REPO = Path(__file__).resolve().parents[2]
DEFAULT_DP = (1, 2, 4, 8)
DEFAULT_PROCS = (2, 4)
# seconds a bench_multichip point, a worker process
POINT_TIMEOUT = 1800
WORKER_TIMEOUT = 600
# rendezvous attempts of a multi-process point, each on a fresh port
RENDEZVOUS_TRIES = 3
IN_USE = "EADDRINUSE"


class PointFailed(Exception):
    """A point of the study that did not run to a right result."""


def run_point(n: int, batch: int, iters: int, orientation: str,
              device: str, quick: bool, cards: int = 0,
              tp: int = 1) -> dict:
    """``bench_multichip`` on ``n`` positions, groups of ``tp`` (dp =
    n / tp): its JSON line, with ``pinned_cores`` (CPU: the cores it was
    pinned to, None when oversubscribed) or ``shared_card`` (CUDA: more
    positions than the ``cards``).  Raises PointFailed on a failed run or
    decode errors."""
    cmd = [sys.executable, "-m", "tfhe_fbs_map_tpu_torch.bench_multichip",
           "--batch-per-chip", str(batch), "--iters", str(iters),
           "--orientation", orientation, "--tp", str(tp)]
    pin = None
    if device == "cpu":
        cmd += ["--quick", "--cpu-devices", str(n)]
        cores = os.cpu_count() or 1
        if n <= cores and shutil.which("taskset"):
            # one host core a position: cores stand in for chips, so weak
            # scaling over the pinned points is a real efficiency
            pin = n
            cmd = ["taskset", "-c", f"0-{n - 1}" if n > 1 else "0"] + cmd
    else:
        cmd += ["--dp", str(n // tp)] + (["--quick"] if quick else [])
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=POINT_TIMEOUT)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    r = json.loads(lines[-1]) if lines else {}
    label = f"{n} positions, tp={tp}"
    if r.get("errors"):
        raise PointFailed(f"{label}: {r['errors']} decode errors")
    if out.returncode != 0 or not r:
        raise PointFailed(f"{label}: exit {out.returncode}\n{out.stderr}")
    if device == "cpu":
        r["pinned_cores"] = pin
    else:
        r["shared_card"] = n > cards
    return r


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(procs: int, device: str, port: int) -> list[tuple]:
    """(exit code, output) of each of ``procs`` worker processes in one
    group on ``port``; every process it starts has ended when it returns."""
    running = []
    try:
        for rank in range(procs):
            env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
                   "LOCAL_RANK": str(rank),
                   "LOCAL_WORLD_SIZE": str(procs)}
            if device == "cpu":
                env["OMP_NUM_THREADS"] = "1"
            running.append(subprocess.Popen(
                [sys.executable, "-m",
                 "tfhe_fbs_map_tpu_torch.parallel.worker",
                 f"127.0.0.1:{port}", str(procs), str(rank), "--device",
                 device], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        for p in running:
            try:
                out = p.communicate(timeout=WORKER_TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + "\n(timed out)"
            outs.append((p.returncode, out))
        return outs
    finally:
        for p in running:
            if p.poll() is None:
                p.kill()
                p.communicate()


def run_multiprocess(procs: int, device: str) -> dict:
    """``procs`` worker processes in one gloo group, each holding its
    positions of the global mesh (two on the CPU, its share of the cards on
    CUDA): how many ran to ``DISTRIBUTED_OK`` and the wall seconds."""
    t0 = time.time()
    for _ in range(RENDEZVOUS_TRIES):
        outs = _run_workers(procs, device, _free_port())
        if not any(IN_USE in out for _, out in outs):
            break
    ok = sum(rc == 0 and f"DISTRIBUTED_OK rank={rank} " in out
             for rank, (rc, out) in enumerate(outs))
    res = {"metric": "torch_distributed_multiprocess", "procs": procs,
           "device": device, "ok": ok, "errors": procs - ok,
           "wall_s": round(time.time() - t0, 1)}
    if ok != procs:
        res["output"] = [out[-2000:] for _, out in outs]
    return res


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def study(device: str, batch: int, iters: int, orientation: str,
          quick: bool, dps=DEFAULT_DP, procs=DEFAULT_PROCS) -> dict:
    """Every point (``dps``, dp=1 first: the efficiency's base; ``procs``
    processes a multi-process point) and the efficiency over the real
    ones; raises PointFailed on the first point that failed."""
    cores = os.cpu_count() or 1
    extra: dict = {}
    cards = 0
    if device == "cuda":
        import torch
        cards = torch.cuda.device_count()
        extra = {"card": card_line(), "kind": torch.cuda.get_device_name(0),
                 "cards": cards}
    points = []
    for n in dps:
        r = run_point(n, batch, iters, orientation, device, quick, cards)
        points.append(r)
        where = (("pinned " + str(r["pinned_cores"]) + " cores"
                  if r["pinned_cores"] else "oversubscribed")
                 if device == "cpu" else
                 ("shared card" if r["shared_card"] else "own card"))
        print(f"dp={n}: {r['value']} boots/s total "
              f"({r['boots_per_sec_per_chip']}/position, {where})",
              flush=True)
    real = [p for p in points if (p["pinned_cores"] if device == "cpu"
                                  else not p["shared_card"])]
    base = points[0]["value"] if points[0] in real else None
    effs = ({p["dp"]: round(p["value"] / (p["dp"] * base), 3)
             for p in real} if base else {})
    top = max(effs, default=None)
    mp_pts = [run_multiprocess(n, device) for n in procs]
    for mp in mp_pts:
        print(f"procs={mp['procs']}: ok={mp['ok']}/{mp['procs']} "
              f"({mp['wall_s']}s)", flush=True)
        if mp["errors"]:
            raise PointFailed(f"procs={mp['procs']}: {mp['errors']} ranks "
                              f"failed\n" + "\n".join(mp["output"]))
    tp_pts = [run_point(n, batch, iters, "matmul", device, quick, cards,
                        tp=n) for n in (1, 2)]
    tp_real = all(p["pinned_cores"] if device == "cpu"
                  else not p["shared_card"] for p in tp_pts)
    tp_eff = (round(tp_pts[1]["value"] / (2 * tp_pts[0]["value"]), 3)
              if tp_real else None)
    print(f"tp=2: {tp_pts[1]['value']} boots/s total vs matmul dp=1 "
          f"{tp_pts[0]['value']} -> efficiency {tp_eff}", flush=True)
    if device == "cpu":
        note = ("CPU mesh: host cores stand in for chips on the pinned "
                "points (taskset), no interconnect; dp points: keys "
                "replicated, no collectives in the hot path")
    else:
        note = (f"{cards} visible card(s): a point with more positions than "
                f"cards shares a card and is left out of the efficiency"
                + ("; on one card only dp=1 is real, so no scaling is "
                   "measured" if cards == 1 else ""))
    note += ("; tp=2 = the matmul orientation with the key contraction "
             "sharded, the partial products summed once a CMux step"
             + ("" if tp_real else " (the tp=2 point shares a card: no "
                "efficiency)")
             + "; multiprocess = parallel.worker processes in one gloo "
             "group, correctness evidence")
    return {
        "metric": f"dp_scaling_efficiency_{device}",
        "device": device, **extra,
        "host_cores": cores,
        "batch_per_chip": batch,
        "orientation": orientation,
        "points": points,
        "efficiency_core_proportional": effs,
        "efficiency": effs[top] if top and top > 1 else None,
        "efficiency_devices": top if top and top > 1 else None,
        "oversubscribed_total_boots_per_sec": {
            p["dp"]: p["value"] for p in points if p not in real},
        "tp_points": tp_pts,
        "tp2_efficiency": tp_eff,
        "multiprocess_points": mp_pts,
        "note": note,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--batch-per-chip", type=int, default=48)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--orientation", default="fused_otf",
                    choices=["fused", "fused_otf"])
    ap.add_argument("--quick", action="store_true",
                    help="CUDA: the tiny family (the CPU always takes it)")
    ap.add_argument("--out", default=None,
                    help="default outputs/h100/scaling_<device>.json")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("--device cuda: no CUDA device is available",
                  file=sys.stderr)
            return 2
    try:
        result = study(args.device, args.batch_per_chip, args.iters,
                       args.orientation, args.quick, DEFAULT_DP,
                       DEFAULT_PROCS)
    except PointFailed as e:
        print(f"scaling study failed: {e}", file=sys.stderr)
        return 1
    out = Path(args.out or REPO / "outputs" / "h100"
               / f"scaling_{args.device}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"efficiency": result["efficiency_core_proportional"],
                      "out": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
