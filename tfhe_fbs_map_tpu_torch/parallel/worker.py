"""One process of a multi-process dp-sharded bootstrap, checked bitwise.

    python -m tfhe_fbs_map_tpu_torch.parallel.worker HOST:PORT PROCS RANK \\
        [--device cpu|cuda]

The counterpart of the JAX package's ``tests/_distributed_worker.py``: the
processes join one gloo group (:func:`.distributed.init_distributed`),
each holds its positions of the global dp mesh (two CPU positions a
process with ``--device cpu``, as the JAX worker holds two virtual
devices; on CUDA its share of the visible cards,
:func:`.distributed.local_gpus`), and one batched functional bootstrap
runs dp-sharded over the global mesh through K1 (``fused_otf``; on the
card N=128 takes its small-N kernel).  Every process builds the same keys
and ciphertexts from the JAX worker's seeds and family (n=16, k=1, N=128,
l=2, b=8), decrypts its own slices, gathers every process's decryptions
and checks the whole batch against the table; it also checks its own
output shards bitwise against the same bootstrap run on its first device
alone.  Prints ``DISTRIBUTED_OK rank=R procs=P positions=D launches=L`` and
exits 0 on success, exits 1 on a wrong result.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["BATCH", "TABLE", "main"]

BATCH = 8          # the whole batch over the global mesh (the JAX worker's)
TABLE = [1, 0, 1]
CPU_POSITIONS = 2  # positions a process on the CPU


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("coordinator", help="HOST:PORT of rank 0")
    ap.add_argument("procs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ..bench_multichip import QUICK_PARAMS
    from ..ops import fused_blind_rotate as fbr
    from ..ops.blind_rotate import (functional_bootstrap_fast,
                                    prepare_fast_keys)
    from ..tfhe import (build_test_vector, decrypt_values, encrypt_values,
                        generate_keys)
    from .distributed import (gather_outputs, global_mesh, init_distributed,
                              shutdown)
    from .mesh import shard_batch, sharded_bootstrap

    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    init_distributed(args.coordinator, args.procs, args.rank)
    try:
        mesh = global_mesh(devices=["cpu"] * CPU_POSITIONS
                           if args.device == "cpu" else None)
        dev = mesh.devices[0]
        params = QUICK_PARAMS
        # identical seeds on every process: identical keys and plaintexts
        keys = generate_keys(params, seed=3, device=dev)
        fast = prepare_fast_keys(keys, orientation="fused_otf")
        rng = np.random.default_rng(4)
        values = rng.integers(0, 3, BATCH)
        cts = encrypt_values(keys, values, rng)
        tv, post = build_test_vector(TABLE, params)
        tvs = torch.from_numpy(np.tile(np.asarray(tv, np.int32), (BATCH, 1)))
        posts = torch.full((BATCH,), int(np.int64(post).astype(np.uint32)
                                         .astype(np.int32)),
                           dtype=torch.int32)
        shards = [shard_batch(mesh, x) for x in (cts, tvs, posts)]
        before = fbr.LAUNCHES["k1"]
        out = sharded_bootstrap(mesh, fast)(*shards)
        launches = fbr.LAUNCHES["k1"] - before
        own = torch.cat([o.to(dev) for o in out])
        alone = functional_bootstrap_fast(fast, *(torch.cat(
            [s.to(dev) for s in sh]) for sh in shards))
        got = gather_outputs({"v": decrypt_values(keys, own)})["v"]
        want = np.asarray(TABLE)[values]
        ok = bool(torch.equal(own, alone)) and np.array_equal(got, want)
    finally:
        shutdown()
    if not ok:
        print(f"DISTRIBUTED_WRONG rank={args.rank}: got {got.tolist()}, "
              f"want {want.tolist()}", file=sys.stderr)
        return 1
    print(f"DISTRIBUTED_OK rank={args.rank} procs={args.procs} "
          f"positions={mesh.dp} launches={launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
