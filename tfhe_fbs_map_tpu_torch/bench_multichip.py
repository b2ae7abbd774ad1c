"""Batched bootstraps a second over a (dp, tp) mesh.

    python -m tfhe_fbs_map_tpu_torch.bench_multichip           # every GPU
    python -m tfhe_fbs_map_tpu_torch.bench_multichip --quick --dp 2
    python -m tfhe_fbs_map_tpu_torch.bench_multichip --quick --cpu-devices 4
    python -m tfhe_fbs_map_tpu_torch.bench_multichip --quick --cpu-devices 4 \\
        --tp 2 --orientation matmul

The port of ``experiments/bench_multichip.py``: ``--batch-per-chip``
ciphertexts a dp group, the whole batch split over dp (each position
runs the fused kernel on its slice with replicated keys,
:func:`.parallel.mesh.sharded_bootstrap`; with ``--orientation matmul`` and
``--tp`` > 1 a group's tp positions each hold a slice of the key
contraction and sum their partial products every step), one checked call, then
``--iters`` timed calls each fed the last one's output.  Values in [0, 2]
under the table [1, 0, 1], keys from seed 1 and values from seed 2, at the
JAX script's family (n=630, k=2, N=512, l=2, b=8, key switch 5×3), or its
tiny one with ``--quick`` (N=128: on the card K1's small-N kernel).  The
mesh is every visible GPU (dp = GPUs / tp), ``--dp`` groups of ``--tp``
positions dealt round-robin over them (more positions than cards share a
card: ``devices`` in the JSON counts the cards), or ``--cpu-devices``
positions on the CPU (dp = positions / tp), where the kernels run their
plain versions.  The chain is decrypt-checked after the first call and
after the timed ones.  Per-chip figures divide by the positions used.
A mesh on one card measures no scaling.  Prints one JSON object, the JAX script's keys;
exits 1 when a bootstrap decrypted wrong, 2 when the mesh cannot be made.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .tfhe.params import TFHEParams

__all__ = ["PARAMS", "QUICK_PARAMS", "ITERS", "main"]

TABLE = [1, 0, 1]
ITERS = 8            # timed calls, after one checked call
PARAMS = TFHEParams(p=4, lwe_dim=630, glwe_dim=2, poly_size=512,
                    bsk_level=2, bsk_base_log=8, ksk_level=5, ksk_base_log=3,
                    lwe_noise_std=2.0 ** (32 - 15.0),
                    glwe_noise_std=2.0 ** (32 - 25.0))
QUICK_PARAMS = TFHEParams(p=4, lwe_dim=16, glwe_dim=1, poly_size=128,
                          bsk_level=2, bsk_base_log=8, ksk_level=3,
                          ksk_base_log=4, lwe_noise_std=2.0,
                          glwe_noise_std=2.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-per-chip", type=int, default=512)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--orientation", default="fused_otf",
                    choices=["fused", "fused_otf", "matmul"])
    ap.add_argument("--quick", action="store_true",
                    help="the tiny insecure family, at most 16 ciphertexts "
                         "a position and 2 timed calls")
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="N mesh positions on the CPU instead of the GPUs")
    ap.add_argument("--dp", type=int, default=None,
                    help="dp groups over the GPUs, round-robin (default: "
                         "the GPUs over tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis: shards the key "
                         "contraction of --orientation matmul (the "
                         "partial products meet once a step)")
    args = ap.parse_args(argv)

    from .ops.blind_rotate import prepare_fast_keys
    from .parallel.mesh import (check_tp, make_mesh, shard_batch,
                                sharded_bootstrap)
    from .tfhe import (build_test_vector, decrypt_values, encrypt_values,
                       generate_keys)

    try:
        if args.cpu_devices and args.dp is not None:
            raise ValueError("--dp deals positions over the GPUs; "
                             "--cpu-devices gives the CPU's")
        check_tp(args.tp, args.orientation)
        mesh = make_mesh(["cpu"] * args.cpu_devices if args.cpu_devices
                         else None, dp=args.dp, tp=args.tp)
    except (ValueError, RuntimeError) as e:
        print(e, file=sys.stderr)
        return 2
    if args.quick:
        params = QUICK_PARAMS
        args.batch_per_chip = min(args.batch_per_chip, 16)
        args.iters = min(args.iters, 2)
    else:
        params = PARAMS
    dev = mesh.devices[0]
    dp = mesh.dp

    keys = generate_keys(params, seed=1, device=dev)
    fast = prepare_fast_keys(keys, orientation=args.orientation)
    fn = sharded_bootstrap(mesh, fast)

    batch = args.batch_per_chip * dp
    rng = np.random.default_rng(2)
    values = rng.integers(0, 3, batch)
    cts = encrypt_values(keys, values, rng)
    tv, post = build_test_vector(TABLE, params)
    tvs = torch.from_numpy(np.tile(np.asarray(tv, np.int32), (batch, 1)))
    posts = torch.full((batch,), int(np.int64(post).astype(np.uint32)
                                     .astype(np.int32)), dtype=torch.int32)
    cts_s, tvs_s, posts_s = (shard_batch(mesh, x) for x in (cts, tvs, posts))

    def sync():
        if dev.type == "cuda":
            for d in mesh.distinct:
                torch.cuda.synchronize(d)

    def wrong(out, calls: int) -> int:
        """Wrong decryptions after ``calls`` chained calls: table[values]
        after an odd number, its complement after an even one."""
        want = np.asarray(TABLE)[values]
        if calls % 2 == 0:
            want = 1 - want
        got = decrypt_values(keys, torch.cat([o.to(dev)
                                              for o in mesh.leaders(out)]))
        return int(np.sum(got != want))

    out = fn(cts_s, tvs_s, posts_s)
    sync()
    n_bad = wrong(out, 1)

    t0 = time.time()
    for _ in range(args.iters):
        out = fn(out, tvs_s, posts_s)
    sync()
    elapsed = time.time() - t0
    n_bad += wrong(out, 1 + args.iters)

    boots_per_sec = batch * args.iters / elapsed
    print(json.dumps({
        "metric": "bootstraps_per_sec_total",
        "value": round(boots_per_sec, 1),
        "devices": len(mesh.distinct),
        "dp": dp,
        "tp": mesh.tp,
        "boots_per_sec_per_chip": round(boots_per_sec
                                        / len(mesh.devices), 1),
        "batch_per_chip": args.batch_per_chip,
        "orientation": args.orientation,
        "errors": n_bad,
    }))
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
