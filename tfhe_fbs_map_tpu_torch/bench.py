"""Bootstraps per second of the staged p=32 lookup, on one GPU.

    python -m tfhe_fbs_map_tpu_torch.bench --preset p32 [--batch 512]
    python -m tfhe_fbs_map_tpu_torch.bench --preset p32 --quick   # CPU

The counterpart of ``bench.py --preset p32`` of the JAX package (its
``staged_p32_bench``).  Workload: five random 32-entry tables over one
shared 5-bit encrypted address; each counted bootstrap is a full size-32
lookup, a size-16 stage-1 bootstrap (fam1) and a size-8 select (fam2), both
through the compact-key kernel K1 (``fused_otf``).  The five outputs become
the next address, pre-scaled so that every lincomb multiplier is 1, so the
chain is decrypt-checked after the first step and after the timed loop:
only correct lookups are counted.  Parameters are the ``p32_staged`` preset
(``optimize_staged(32, 4, 2, max_p_error=1e-6)``'s pick); ``--quick`` takes
tiny insecure families on the CPU.  Prints one JSON object, the JAX bench's
keys, as its last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["staged_p32_bench", "main"]

LANES = 5
COEFS = [1, 2, 4, 8, 16]
ITERS = 8            # timed steps, after one checked first step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def staged_p32_bench(batch: int, iters: int, quick: bool,
                     device: torch.device) -> dict:
    """Key generation, the first (checked) step, then ``iters`` timed
    steps of ``LANES × batch`` staged lookups, checked at the end."""
    from .ops.blind_rotate import prepare_fast_keys
    from .runtime.executor import _staged_level_step
    from .tfhe.encrypt import lwe_phase
    from .tfhe.params import STAGED_PRESETS
    from .tfhe.pbs import build_test_vector
    from .tfhe.staged import encrypt_wires, generate_staged_keys, split_node

    preset = STAGED_PRESETS["staged_test" if quick else "p32_staged"]
    p, fam1, fam2 = preset.p, preset.fam1, preset.fam2
    t0 = time.time()
    skeys = generate_staged_keys(p, fam1, fam2, seed=1, device=device)
    fast1 = prepare_fast_keys(skeys.keys1, orientation="fused_otf")
    fast2 = prepare_fast_keys(skeys.keys2, orientation="fused_otf")
    _sync(device)
    keygen_s = time.time() - t0
    print(f"# staged keygen done in {keygen_s:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(2)
    delta_w, delta2 = skeys.wire_params.delta, skeys.keys2.params.delta
    # role scales: stage 1 wants 2*c_i*delta_w on roles 0-3, stage 2 wants
    # c_4*delta_w on role 4; pre-scaled outputs make every multiplier 1
    scales = [2 * c for c in COEFS[:4]] + [COEFS[4]]
    tables = [rng.integers(0, 2, p).tolist() for _ in range(LANES)]
    splits = [split_node(COEFS, 0, t, p) for t in tables]
    # stage 1 takes roles 0-3 and stage 2 role 4, with no constant
    assert all(s is not None and s.a_idx == (0, 1, 2, 3) and s.b_idx == (4,)
               and s.const_lo == s.const_hi == 0 for s in splits)
    tv1s, post1s, tv2s, post2s = [], [], [], []
    for lane, s in enumerate(splits):
        tv1, post1 = build_test_vector(s.t1, fam1, out_delta=delta2)
        # a lane's output is the next step's role-`lane` wire
        tv2, post2 = build_test_vector(s.t2, fam2,
                                       out_delta=scales[lane] * delta_w)
        tv1s.append(tv1), post1s.append(post1)
        tv2s.append(tv2), post2s.append(post2)

    def i32(rows) -> torch.Tensor:
        arr = np.asarray(rows, np.int64).astype(np.uint32).astype(np.int32)
        return torch.from_numpy(arr).to(device)

    # a step is one level of the staged executor: LANES split nodes on the
    # wire buffer [2·LANES + 1, B, d], rows 0-4 the address wires, rows 5-9
    # the lookups, row 10 the dummy that takes stage 1's scatter; every
    # multiplier is 1.  The lookups then become the next address.
    plan = (i32([range(4)] * LANES), i32(np.ones((LANES, 4))),
            i32([0] * LANES), i32(tv1s), i32(post1s),
            i32([2 * LANES] * LANES),
            i32([[4]] * LANES), i32([[1]] * LANES), i32([0] * LANES),
            i32(tv2s), i32(post2s), i32(range(LANES, 2 * LANES)))
    bits = rng.integers(0, 2, (LANES, batch))
    regs = torch.stack([encrypt_wires(skeys, bits[i], rng, scale=scales[i])
                        for i in range(LANES)])          # [5, B, kN+1]
    buf = torch.cat([regs, regs.new_zeros((LANES + 1, *regs.shape[1:]))])
    regs = buf[:LANES]

    def step():
        _staged_level_step(skeys.keys1, skeys.keys2, fast1, fast2, LANES,
                           buf, *plan)
        buf[:LANES] = buf[LANES:2 * LANES]

    def model_step(bits):
        addr = sum(bits[i] * COEFS[i] for i in range(LANES))
        return np.stack([np.asarray(tables[i])[addr] for i in range(LANES)])

    def wrong(regs, bits) -> int:
        phases = lwe_phase(skeys.extracted_key,
                           regs.reshape(LANES * batch, -1)).cpu().numpy()
        u = phases.astype(np.uint32).astype(np.float64)
        got = np.round(u / delta_w).astype(np.int64) % (2 * p)
        want = (bits * np.asarray(scales)[:, None]).reshape(-1)
        return int(np.sum(got != want))

    _sync(device)
    t0 = time.time()
    step()
    _sync(device)
    compile_s = time.time() - t0
    bits = model_step(bits)
    n_bad = wrong(regs, bits)
    if n_bad:
        print(f"CORRECTNESS FAILURE: {n_bad}/{LANES * batch} wrong",
              file=sys.stderr)

    t0 = time.time()
    for _ in range(iters):
        step()
    _sync(device)
    elapsed = time.time() - t0
    for _ in range(iters):
        bits = model_step(bits)
    bad_loop = wrong(regs, bits)
    if bad_loop:
        print(f"CORRECTNESS FAILURE (timed loop): {bad_loop} wrong",
              file=sys.stderr)
    n_bad += bad_loop

    boots = LANES * batch * iters      # one staged p32 lookup per lane
    boots_per_sec = boots / elapsed
    return {
        "metric": "bootstraps_per_sec_per_chip",
        "value": round(boots_per_sec, 2),
        "unit": "boots/s",
        "vs_baseline": round(boots_per_sec / 1000.0, 3),
        "batch": LANES * batch,
        "staged": True,
        "params": {"n": fam1.lwe_dim, "p": p,
                   "fam1": {"k": fam1.glwe_dim, "N": fam1.poly_size,
                            "l_bsk": fam1.bsk_level},
                   "fam2": {"k": fam2.glwe_dim, "N": fam2.poly_size,
                            "l_bsk": fam2.bsk_level}},
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "keygen_s": round(keygen_s, 2),
        "compile_s": round(compile_s, 2),
        "ms_per_bootstrap": round(1000.0 * elapsed / boots, 4),
        "errors": n_bad,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="p32", choices=["p32"],
                    help="the staged p=32 lookup (the anchor, p8 and p16 "
                         "presets are not ported yet)")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--quick", action="store_true",
                    help="tiny insecure families, batch at most 8 (a CPU "
                         "smoke test)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="default: cpu with --quick, else cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device or ("cpu" if args.quick else "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available (--quick runs on "
              "the CPU)", file=sys.stderr)
        return 2
    batch = min(args.batch, 8) if args.quick else args.batch
    result = staged_p32_bench(batch, args.iters, args.quick, device)
    print(json.dumps(result))
    return 1 if result["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
