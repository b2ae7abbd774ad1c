"""Functional bootstraps per second on one GPU.

    python -m tfhe_fbs_map_tpu_torch.bench                   # anchor, B=512
    python -m tfhe_fbs_map_tpu_torch.bench --preset p16 --orientation fused_otf
    python -m tfhe_fbs_map_tpu_torch.bench --orientation matmul --bsk-limbs 3
    python -m tfhe_fbs_map_tpu_torch.bench --orientation keys_lhs
    python -m tfhe_fbs_map_tpu_torch.bench --preset p32 --native-p32
    python -m tfhe_fbs_map_tpu_torch.bench --preset p32      # staged lookups
    python -m tfhe_fbs_map_tpu_torch.bench --quick           # tiny, on the GPU
    python -m tfhe_fbs_map_tpu_torch.bench --quick --device cpu

The port of the JAX package's root ``bench.py``.  The native presets
(``anchor``, the ~128-bit p=4 headline set; ``p8``; ``p16``; ``p32`` with
``--native-p32``, one N=2048 bootstrap a lookup) run its XOR chain: values
in [0, 2] under the table [1, 0, 1], a fresh bootstrap output fed back
through the same bootstrap, through the fused kernel ``--orientation``
names (``auto``: K2 when its key matrices fit the card's free memory, the
runtime CLI's rule, else K1) or through ``matmul``, the JAX bench's XLA
anchor: one ``torch._int_mm`` a CMux step over K2's key matrices
(``--bsk-limbs 3``: a quantized key), or through a conv orientation
(``keys_rhs``, ``keys_lhs``, ``keys_lhs_bf16``: one product a CMux step
of the step's compact-key windows, all four key limbs), whose anchor is
the JAX bench's own conv set :data:`CONV_ANCHOR`.  ``--preset p32``
alone is the staged p=32 lookup (``staged_p32_bench``).  Every chain is
decrypt-checked after its first step and after the timed loop, so only
correct bootstraps are counted.  ``--quick`` takes the JAX bench's tiny insecure sets (N=128,
which K1 serves through its small-N kernel), on the card as the JAX bench
runs it on its accelerator, or with ``--device cpu`` on the CPU through
the kernels' plain versions.  Prints one JSON object, the JAX
bench's keys (and ``orientation`` and ``bsk_limbs`` for a native preset),
as its last line; exits 1 when a bootstrap decrypted wrong, 2 when the
device or the kernel asked for cannot run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from .ops.blind_rotate import CONV_ORIENTATIONS
from .ops.fused_blind_rotate import N_LIMBS
from .tfhe.params import PRESETS, TFHEParams

__all__ = ["QUICK_PARAMS", "CONV_ANCHOR", "XorChain", "bench_orientation",
           "native_bench", "staged_p32_bench", "run_chain", "main"]

LANES = 5
COEFS = [1, 2, 4, 8, 16]
ITERS = 8            # timed steps, after one checked first step
# the XOR chain's table over lincomb values in [0, 2]: 1 - x on {0, 1}, so
# the chain alternates
TABLE = [1, 0, 1]
# bench.py:61-66, the JAX bench's --quick set
QUICK_PARAMS = TFHEParams(p=4, lwe_dim=32, glwe_dim=1, poly_size=128,
                          bsk_level=2, bsk_base_log=7, ksk_level=3,
                          ksk_base_log=4, lwe_noise_std=4.0,
                          glwe_noise_std=4.0)
QUICK_BATCH = {"native": 32, "staged": 8}
# bench.py:104-111, the JAX bench's anchor for the conv orientations: ~128
# bits at kN = 1024, n = 630, base 2^7 (their digits fit int8 negated)
CONV_ANCHOR = TFHEParams(p=4, lwe_dim=630, glwe_dim=2, poly_size=512,
                         bsk_level=3, bsk_base_log=7, ksk_level=5,
                         ksk_base_log=3, lwe_noise_std=2.0 ** 17,
                         glwe_noise_std=2.0 ** 7)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _i32(rows, device: torch.device) -> torch.Tensor:
    arr = np.asarray(rows, np.int64).astype(np.uint32).astype(np.int32)
    return torch.from_numpy(arr).to(device)


def run_chain(step, wrong, iters: int, device: torch.device,
              trace: str | None = None) -> tuple[float, float, int]:
    """One first step, checked, then ``iters`` timed steps between two
    synchronisations (under ``torch.profiler`` into ``trace`` when given),
    checked at the end.  ``wrong(steps)`` counts the wrong outputs after
    ``steps`` steps.  Returns (first step's seconds, timed seconds, wrong
    outputs)."""
    from .utils.profiling import torch_trace

    _sync(device)
    t0 = time.time()
    step()
    _sync(device)
    compile_s = time.time() - t0
    n_bad = wrong(1)
    if n_bad:
        print(f"CORRECTNESS FAILURE: {n_bad} wrong", file=sys.stderr)
    with torch_trace(trace) if trace else contextlib.nullcontext():
        t0 = time.time()
        for _ in range(iters):
            step()
        _sync(device)
        elapsed = time.time() - t0
    bad_loop = wrong(1 + iters)
    if bad_loop:
        print(f"CORRECTNESS FAILURE (timed loop): {bad_loop} wrong",
              file=sys.stderr)
    return compile_s, elapsed, n_bad + bad_loop


def _result(boots: int, batch: int, params: dict, device: torch.device,
            keygen_s: float, timing: tuple[float, float, int],
            **extra) -> dict:
    """The JAX bench's JSON line, with ``extra`` keys after it."""
    compile_s, elapsed, n_bad = timing
    rate = boots / elapsed
    return {
        "metric": "bootstraps_per_sec_per_chip",
        "value": round(rate, 2),
        "unit": "boots/s",
        "vs_baseline": round(rate / 1000.0, 3),
        "batch": batch,
        "params": params,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "keygen_s": round(keygen_s, 2),
        "compile_s": round(compile_s, 2),
        "ms_per_bootstrap": round(1000.0 * elapsed / boots, 4),
        "errors": n_bad,
        **extra,
    }


# ------------------------------------------------------------ native presets

def bench_orientation(params: TFHEParams, orientation: str, bsk_limbs: int,
                      device: torch.device,
                      free_bytes: int | None = None) -> str:
    """The fused kernel a native bench runs.  On CUDA, ``auto`` is the
    runtime CLI's ``pick_orientations`` (K1, ``"fused_otf"``, where K2,
    ``"fused"``, does not serve ``params`` or its ``bsk_limbs`` key
    matrices do not fit ``free_bytes``, by default the card's free memory,
    with ``FUSED_HEADROOM`` to spare; else the one of the lower calibrated
    price).  An orientation asked for must be
    served and, for K2, fit: ValueError otherwise, since the bench never
    runs another kernel than the one asked for.  On the CPU both wrappers run their plain
    versions, and ``auto`` takes ``"fused"``, the JAX bench's default.
    ``"matmul"`` holds K2's key matrices too, so on CUDA they must fit as
    K2's do.  A conv orientation, on either device, keeps all four key
    limbs and must run ``params`` (``check_kernel``)."""
    from .ops.blind_rotate import FUSED_HEADROOM, fused_key_bytes
    from .runtime.cli import check_kernel, free_memory, pick_orientations

    if orientation in CONV_ORIENTATIONS:
        if bsk_limbs != N_LIMBS:
            raise ValueError(f"--orientation {orientation} keeps all "
                             f"{N_LIMBS} key limbs; --bsk-limbs {bsk_limbs} "
                             f"takes fused, fused_otf or matmul")
        check_kernel(params, orientation, device)
        return orientation
    if device.type != "cuda":
        return "fused" if orientation == "auto" else orientation
    if free_bytes is None:
        free_bytes = free_memory(device)
    if orientation == "auto":
        return pick_orientations([params], device, free_bytes, bsk_limbs)[0]
    check_kernel(params, orientation)
    need = fused_key_bytes(params, bsk_limbs)
    if orientation in ("fused", "matmul") \
            and need + FUSED_HEADROOM > free_bytes:
        raise ValueError(
            f"--orientation {orientation}: K2's key matrices take "
            f"{need / 1e9:.1f} "
            f"GB, with {FUSED_HEADROOM >> 30} GiB to spare, and the card has "
            f"{free_bytes / 1e9:.1f} GB free; --orientation fused_otf runs "
            f"K1 on the compact keys")
    return orientation


class XorChain:
    """The JAX bench's workload (``bench.py:134-178``): values
    ``default_rng(2).integers(0, 3, batch)`` encrypted under ``keys``, each
    ``step`` one batched fast bootstrap of the current ciphertexts under
    :data:`TABLE`, fed back into the next."""

    def __init__(self, keys, fast, batch: int):
        from .optimizer.runtime_model import launch_choice
        from .tfhe.encrypt import encrypt_values
        from .tfhe.pbs import build_test_vector

        self.keys, self.fast = keys, fast
        # the route and plan the cost model chooses for the chain's launch
        self.choice = launch_choice(keys.params, batch, 1, fast.orientation,
                                    fast.limbs, fast.route,
                                    keys.device.type == "cuda")
        rng = np.random.default_rng(2)
        self.values = rng.integers(0, 3, batch)
        self.cts = encrypt_values(keys, self.values, rng)
        tv, post = build_test_vector(TABLE, keys.params)
        self.tvs = _i32(np.tile(tv, (batch, 1)), keys.device)
        self.posts = _i32(np.full(batch, post), keys.device)

    def step(self) -> None:
        from .ops.blind_rotate import functional_bootstrap_fast

        self.cts = functional_bootstrap_fast(self.fast, self.cts, self.tvs,
                                             self.posts, None, self.choice)

    def wrong(self, steps: int) -> int:
        """Wrong decryptions after ``steps`` ≥ 1 steps: table[values] after
        an odd number, its complement after an even one."""
        from .tfhe.encrypt import decrypt_values

        want = np.asarray(TABLE)[self.values]
        if steps % 2 == 0:
            want = 1 - want
        return int(np.sum(decrypt_values(self.keys, self.cts) != want))


def native_bench(params: TFHEParams, batch: int, iters: int,
                 orientation: str, bsk_limbs: int, device: torch.device,
                 trace: str | None = None) -> dict:
    """Keys (``generate_keys(params, seed=1)``) and the fast keys of
    ``orientation``, timed as ``keygen_s``; then the XOR chain of ``batch``
    ciphertexts, ``iters`` timed steps after a checked first one."""
    from .ops.blind_rotate import prepare_fast_keys
    from .tfhe.keys import generate_keys

    t0 = time.time()
    keys = generate_keys(params, seed=1, device=device)
    fast = prepare_fast_keys(keys, orientation=orientation,
                             bsk_limbs=bsk_limbs)
    _sync(device)
    keygen_s = time.time() - t0
    print(f"# keygen + {orientation} keys ({bsk_limbs} limbs) done in "
          f"{keygen_s:.1f}s", file=sys.stderr)
    chain = XorChain(keys, fast, batch)
    timing = run_chain(chain.step, chain.wrong, iters, device, trace)
    return _result(batch * iters, batch,
                   {"n": params.lwe_dim, "k": params.glwe_dim,
                    "N": params.poly_size, "l_bsk": params.bsk_level,
                    "p": params.p},
                   device, keygen_s, timing, orientation=orientation,
                   bsk_limbs=bsk_limbs)


# ------------------------------------------------------------- staged p32

def staged_p32_bench(batch: int, iters: int, quick: bool,
                     device: torch.device, trace: str | None = None) -> dict:
    """The staged p=32 lookup (the JAX ``staged_p32_bench``): five random
    32-entry tables over one shared 5-bit encrypted address; each counted
    bootstrap is a full size-32 lookup, a size-16 stage-1 bootstrap (fam1)
    and a size-8 select (fam2), both through K1 (``fused_otf``).  The five
    outputs become the next address, pre-scaled so that every lincomb
    multiplier is 1.  Parameters are the ``p32_staged`` preset
    (``optimize_staged(32, 4, 2, max_p_error=1e-6)``'s pick); ``quick``
    takes the tiny ``staged_test`` families."""
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
        return _i32(rows, device)

    # a step is one level of the staged executor: LANES split nodes on the
    # wire buffer [2·LANES + 1, B, d], rows 0-4 the address wires, rows 5-9
    # the lookups, row 10 the dummy that takes stage 1's scatter; every
    # multiplier is 1.  The lookups then become the next address.
    plan = (i32([range(4)] * LANES), i32(np.ones((LANES, 4))),
            i32([0] * LANES), i32(tv1s), i32(post1s),
            i32([2 * LANES] * LANES),
            i32([[4]] * LANES), i32([[1]] * LANES), i32([0] * LANES),
            i32(tv2s), i32(post2s), i32(range(LANES, 2 * LANES)))
    bits0 = rng.integers(0, 2, (LANES, batch))
    regs = torch.stack([encrypt_wires(skeys, bits0[i], rng, scale=scales[i])
                        for i in range(LANES)])          # [5, B, kN+1]
    buf = torch.cat([regs, regs.new_zeros((LANES + 1, *regs.shape[1:]))])
    regs = buf[:LANES]

    def step():
        _staged_level_step(skeys.keys1, skeys.keys2, fast1, fast2, LANES,
                           buf, *plan)
        buf[:LANES] = buf[LANES:2 * LANES]

    def wrong(steps: int) -> int:
        bits = bits0
        for _ in range(steps):
            addr = sum(bits[i] * COEFS[i] for i in range(LANES))
            bits = np.stack([np.asarray(tables[i])[addr]
                             for i in range(LANES)])
        phases = lwe_phase(skeys.extracted_key,
                           regs.reshape(LANES * batch, -1)).cpu().numpy()
        u = phases.astype(np.uint32).astype(np.float64)
        got = np.round(u / delta_w).astype(np.int64) % (2 * p)
        want = (bits * np.asarray(scales)[:, None]).reshape(-1)
        return int(np.sum(got != want))

    timing = run_chain(step, wrong, iters, device, trace)
    # one staged p32 lookup per lane
    return _result(LANES * batch * iters, LANES * batch,
                   {"n": fam1.lwe_dim, "p": p,
                    "fam1": {"k": fam1.glwe_dim, "N": fam1.poly_size,
                             "l_bsk": fam1.bsk_level},
                    "fam2": {"k": fam2.glwe_dim, "N": fam2.poly_size,
                             "l_bsk": fam2.bsk_level}},
                   device, keygen_s, timing, staged=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="anchor",
                    choices=["anchor", "p8", "p16", "p32"],
                    help="parameter set: the ~128-bit p=4 anchor, or the "
                         "optimizer's picks for FBS sizes 8, 16 and 32 "
                         "(tfhe/params.py PRESETS); p32 is the staged "
                         "lookup unless --native-p32")
    ap.add_argument("--native-p32", action="store_true",
                    help="run the p32 preset as one N=2048 bootstrap a "
                         "lookup (the XOR chain at PRESETS['p32']) instead "
                         "of the staged two-family lookup")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--quick", action="store_true",
                    help="tiny insecure parameters, batch at most 32 (8 "
                         "staged)")
    ap.add_argument("--orientation", default="auto",
                    choices=["auto", "fused", "fused_otf", "matmul",
                             "keys_lhs", "keys_lhs_bf16", "keys_rhs"],
                    help="path of a native preset: K2 (fused) over "
                         "precomputed key matrices, K1 (fused_otf) over the "
                         "compact keys, or auto: K2 when its matrices fit "
                         "the card's free memory, else K1; matmul: one "
                         "torch._int_mm a CMux step over K2's matrices; "
                         "keys_*: the JAX package's conv orientations, the "
                         "anchor preset then being its conv set (n=630, "
                         "l=3, b=7).  A path asked for that cannot run exits "
                         "2.  The staged lookup runs both families on K1")
    ap.add_argument("--bsk-limbs", type=int, default=N_LIMBS,
                    choices=range(1, N_LIMBS + 1), metavar="{1,2,3,4}",
                    help="8-bit limbs of the bootstrapping key kept, most "
                         "significant first (3: a quantized key); native "
                         "presets only")
    ap.add_argument("--trace", metavar="LOGDIR", default=None,
                    help="write a torch.profiler Chrome trace of the timed "
                         "loop into LOGDIR")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: the kernels' plain versions (with --quick)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    if args.preset == "p32" and not args.native_p32:
        if args.orientation not in ("auto", "fused_otf") \
                or args.bsk_limbs != N_LIMBS:
            print(f"the staged p32 lookup runs both families on K1 "
                  f"(fused_otf) with all key limbs; --orientation "
                  f"{args.orientation} and --bsk-limbs take a native preset",
                  file=sys.stderr)
            return 2
        batch = (min(args.batch, QUICK_BATCH["staged"]) if args.quick
                 else args.batch)
        result = staged_p32_bench(batch, args.iters, args.quick, device,
                                  args.trace)
    else:
        if args.quick:
            params = QUICK_PARAMS
        elif args.preset == "anchor" and args.orientation in CONV_ORIENTATIONS:
            params = CONV_ANCHOR
        else:
            params = PRESETS[args.preset][0]
        batch = (min(args.batch, QUICK_BATCH["native"]) if args.quick
                 else args.batch)
        try:
            orientation = bench_orientation(params, args.orientation,
                                            args.bsk_limbs, device)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 2
        result = native_bench(params, batch, args.iters, orientation,
                              args.bsk_limbs, device, args.trace)
    print(json.dumps(result))
    return 1 if result["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
