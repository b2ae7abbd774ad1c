#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tfhe_fbs_map_tpu_torch``) on one GPU.

    python3 chip_smoke.py            # every phase, from the repo root
    python3 chip_smoke.py --quick    # build + kernel checks only

Phases, each printed with what ran and how long it took:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA build;
2. build of the CUDA kernels from ``tfhe_fbs_map_tpu_torch/ops/csrc``;
3. each fused blind-rotation kernel (K1 ``fused_otf``, K2 ``fused``)
   against its plain PyTorch version on the same inputs, bitwise, at
   several parameter shapes, limb drop and ragged batch tiles: each at
   every plan ``k1_plan`` / ``k2_plan`` picks for the main path's batch
   sizes (both up to 8192 ciphertexts at the staged families' shapes) and
   at every plan of one 1024-ciphertext level;
4. the fast functional bootstrap through each kernel against the generic
   exact bootstrap at the ``aes128_p4`` preset, and each kernel against
   its plain version at a main-path level's shape (n=578, B=1024), bitwise,
   with both times and the least time the card could take (the larger of
   its int8 operations over the data sheet's 1,979 TOP/s and its bytes over
   3.35 TB/s); then K1 the same way at each staged family's launch on the
   staged main paths, at full length (n=642 up to 8192 ciphertexts, n=674
   at 2560);
5. the main path: the runtime CLI on the mapped AES-128 program, once with
   ``--orientation auto`` (K2 when its key matrices fit) and once with
   ``fused_otf`` (K1), each required bit-exact and to have launched its
   kernel;
6. the staged main path: the runtime CLI on the Kreyvium-1152 program at
   the ``kreyvium_p10_staged`` preset with ``--orientation auto``, required
   to send both families to K1, to be bit-exact and to have launched K1
   once for every non-empty family call of the staged plan; and the port's
   staged p32 bench (``python -m tfhe_fbs_map_tpu_torch.bench --preset
   p32``), whose steps run the staged executor's split route, required to
   report 0 errors;
7. the optimizer path: the runtime CLI on AES-128 (batch 8) and on
   Kreyvium-1152 (batch 16) with no ``--params`` and ``--p-error 1e-7``,
   so the parameter optimizer picks the families and, for Kreyvium, the
   runtime model routes staged against native.  Before each run, every
   picked family's kernel is held against its plain version at n=8 at the
   run's launch sizes, and the cost model's kernel, plans and waves must
   equal ``pick_orientations``' and ``k1_device_plan`` / ``device_plan``'s
   on the card at every launch of the run; the run must be bit-exact and
   launch the kernel the model priced once for every family call.  Then
   the runtime model's predicted ``run_s`` against the measured one for
   the runs of phases 5 to 7 (``optimizer/validate.py``'s table);
8. the bench and a mapped ISCAS85 program: each kernel at the bench's
   launches at full length (every step, 512 ciphertexts: K2 at anchor, p8
   and p16, K1 at anchor and native p32) against its plain version,
   bitwise, with both times and the bound; then ``bench.main`` at
   ``--preset anchor`` (``auto``: K2), anchor ``--orientation fused_otf``
   (K1), anchor ``--bsk-limbs 3`` (K2 on a quantized key), ``p8``,
   ``p16`` (K2) and ``p32 --native-p32`` (K1 at N=2048), each required to
   launch the kernel its JSON names 1 + iters times and the other never,
   and to report 0 errors; the quantized key is far outside the anchor's
   noise budget, so that run is held to report its errors beside the noise
   model's rate and to exit 1 on them; then c6288r, the 16x16 multiplier,
   mapped at p=4 with ``--opt`` by the port's own ``frontend.cli`` (944
   bootstraps) and run as phase 7 runs its programs, at batch 64;
9. the dp mesh on the one card, two shards on it (so it proves slicing,
   per-shard launches, reassembly and the multi-process wiring, and
   measures no scaling): (a) ``sharded_bootstrap`` at the bench's anchor
   family, 1,024 ciphertexts, through K1 and through K2, each bitwise equal
   to the one-device launch with exactly 2 launches of its kernel; (b) the
   mapped AES-128 program at batch 16 through the mesh executor on K1,
   its final wire buffer bitwise equal to the one-device run's, bit-exact,
   230 × 2 K1 launches; (c) the dry run's staged p=32 program at the
   ``p32_staged`` families through K1, likewise; (d) the runtime CLI as two
   processes over gloo (``--mesh auto``, AES-128 at batch 8, K1), rank 0's
   line bit-exact with dp 2, 230 K1 launches in each rank; (e)
   ``bench_multichip`` at its defaults, errors 0;
10. CUDA graphs: AES-128 at batch 8 through K1 and through ``auto`` (K2),
    staged Kreyvium-1152 at batch 16 (K1) and AES-128 at batch 16 on two
    shards of the card (K1), each once as ``run``'s replay of one CUDA
    graph a level group and then once as the eager level loop (one
    ``step`` a level, as ``run`` walks with a checkpoint), AES-128 through
    K1 both under ``torch.profiler``: each ``run_s``, the capture's seconds,
    the device's idle share over a whole run of each on the profiled row,
    the final wire buffers bitwise equal and bit-exact, and the same
    launches in both runs (230, 230, 28 and 460);
11. the harness: (a) K1 at N=4096 (k=1, l=2, b=8) bitwise against its
    plain version at n=8 at the plan ``k1_plan`` picks for 64, 512, 2048
    and 533 (a ragged tile) ciphertexts, at 4 and 3 limbs, then at full
    length (n=700, 512 ciphertexts) with both times and the bound; (b)
    ``harness.sweep`` (c17 and c432r at p=3, 4 with their p=2 ``basic``
    baselines; s9234r at p=22 and its baseline) into a temporary
    directory, every row's H100 ``boot_cost`` and ``native_rt_est`` finite
    (s9234r p=22 also ``staged_rt_est``) and printed beside the committed
    TPU row, the reference's; (c) each program the sweep wrote through the
    runtime CLI as phase 7 runs its programs, at batch 16 and ``--p-error
    1e-7``, s9234r p=22 with ``--staged on``, ``off`` and ``auto``: every
    run bit-exact with the priced kernel once a family call, ``run_s``
    beside the sweep's estimate of the route taken at that error target
    (which must equal ``predicted_run_s`` within 1%), and whether ``auto``
    took the faster route; then ``harness.analyse`` over the aggregates
    and the runs.

Before the last line it prints one JSON object with a row per kernel (no
PyTorch call computes the n-step recurrence, so ``library_ms`` is null;
``launches`` sums the kernel's launches over the main paths of phases 5 to
11, each counted from 0, ``launches_by_path`` splits them (phase 10's
graph runs as ``graphs ...``, phase 11's as ``sweep ...``);
``staged_launches``, ``bench_launches`` and ``n4096_launches`` hold the
full-length checks of phases 4, 8 and 11) and the card's name and power
limit; the last line is
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
on any failure, without a CUDA device, or away from a checkout of the repo.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
AES_LBF = "outputs/bristol/aes_128_4_search.lbf"
KREYVIUM_LBF = "outputs/generated/kreyvium_stream_v1_10_search.lbf"
KREYVIUM_PRESET = "kreyvium_p10_staged"
KREYVIUM_BATCH = 16
# the JAX package's Pallas kernel bodies each CUDA kernel replaces
REPLACES = {"k2": "tfhe_fbs_map_tpu/ops/fused_blind_rotate.py:102",
            "k1": "tfhe_fbs_map_tpu/ops/fused_blind_rotate.py:160"}
SOURCE = {"k2": "tfhe_fbs_map_tpu_torch/ops/csrc/fused_blind_rotate_k2.cu",
          "k1": "tfhe_fbs_map_tpu_torch/ops/csrc/fused_blind_rotate.cu"}
# Batch of one full level of the mapped AES-128 program at --batch 8: most
# of its 230 levels pad to 128 bootstraps.
LEVEL_BATCH = 1024
# K2's batch sizes at the staged families' shapes
STAGED_K2 = (21, 64, 512, 2048, 8192)
# The staged main paths' K1 launches at full length: (label, (k, N, l, b),
# n, ciphertexts).  Kreyvium-1152 at batch 16 pads its fam1 calls to 512
# bootstraps and its largest fam2 call to 128; the p32 bench at batch 512
# runs 5 lookups a step in each family.
STAGED_LAUNCHES = (
    ("kreyvium_p10_staged fam1", (1, 1024, 4, 5), 642, 8192),
    ("kreyvium_p10_staged fam2", (2, 512, 4, 5), 642, 2048),
    ("p32_staged fam1", (1, 1024, 3, 6), 674, 2560),
    ("p32_staged fam2", (2, 512, 4, 5), 674, 2560),
)
# timed kernel launches per measurement
REPS = 3
# the H100 SXM data sheet's dense int8 rate and memory rate
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(label: str):
    @contextlib.contextmanager
    def ctx():
        import torch
        torch.cuda.synchronize()
        t0 = time.time()
        yield
        torch.cuda.synchronize()
        log(f"[{label}] {time.time() - t0:.3f} s")
    return ctx()


def cuda_ms(fn, reps: int):
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events, after
    one warm-up run; returns them with the warm-up run's result."""
    import torch
    first = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, first


def once_ms(fn):
    """Milliseconds of one run of ``fn``, CUDA events, and its result (the
    plain versions at full length are too slow to run twice)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def kernel_inputs(params, steps: int, batch: int, n_limbs: int, otf: bool,
                  seed: int):
    """Random kernel operands, drawn on the card from a seeded generator
    (K2's matrices reach 32 GB at p16), with the rotation amounts' edge
    cases 0, N-1, N and 2N-1 in every step."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    k1, N = params.glwe_dim + 1, params.poly_size
    rows = k1 * params.bsk_level

    def ints(lo, hi, shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(dtype)

    b_init = ints(0, 2 * N, (batch, 1))
    a_t = ints(0, 2 * N, (steps, batch, 1))
    edges = torch.tensor([0, N - 1, N, 2 * N - 1], dtype=torch.int32,
                         device=dev)[:min(batch, 4)]
    a_t[:, :len(edges), 0] = edges
    b_init[:len(edges), 0] = edges
    tvs = ints(-2 ** 31, 2 ** 31, (batch, N))
    shape = ((steps, n_limbs * k1, rows, 2 * N) if otf
             else (steps, n_limbs * k1 * N, rows * N))
    keys = torch.randint(-128, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)
    return b_init, a_t, tvs, keys


def shape_params(k, N, l, b):
    from tfhe_fbs_map_tpu_torch.tfhe.params import TFHEParams
    return TFHEParams(p=4, lwe_dim=8, glwe_dim=k, poly_size=N, bsk_level=l,
                      bsk_base_log=b, ksk_level=1, ksk_base_log=2,
                      lwe_noise_std=0.0, glwe_noise_std=0.0)


def report(kern: str, label: str, err: int, worst: dict) -> None:
    worst[kern] = max(worst[kern], err)
    log(f"  {kern} {label}: {'bitwise equal' if err == 0 else 'MISMATCH'} "
        f"(max_abs_err {err})")
    if err:
        raise SystemExit(f"{kern} disagrees with its plain version at {label}")


def check_k1(fbr, presets, worst: dict) -> None:
    """Phase 3, K1: bitwise against its plain version on the card, at the
    plans k1_plan picks and at every plan of one 1024-ciphertext level."""
    import torch

    aes = presets["aes128_p4"][0]
    test = presets["test"][0]
    batches = (21, 64, 512, 1024, 2048)
    # a staged level's fam1 call carries up to 512 bootstraps x batch 16
    staged = batches + (4096, 8192)
    every = [(cb, c, w) for cb in fbr.K1_TILES for w in fbr.K1_WIDTHS
             if fbr.k1_fits(cb, w, 4) for c in fbr.k1_clusters(aes, w)]
    # (label, params, steps, limbs, batches, forced (cb, cluster, nw) at
    # batch)
    cases = [
        ("test", test, test.lwe_dim, 4, batches, {}),
        ("aes128_p4 n=8", aes, 8, 4, batches, {1024: every}),
        ("aes128_p4 n=8 bsk_limbs=3", aes, 8, 3, batches, {}),
        ("p16 n=8", presets["p16"][0], 8, 4, batches, {}),
        # p32_staged's families
        ("fam1 k=1 N=1024 l=3 b=6 n=8", shape_params(1, 1024, 3, 6), 8, 4,
         staged, {}),
        ("fam2 k=2 N=512 l=4 b=5 n=8", shape_params(2, 512, 4, 5), 8, 4,
         staged, {}),
        # kreyvium_p10_staged's fam1 (its fam2 has fam2's shape)
        ("kreyvium fam1 k=1 N=1024 l=4 b=5 n=8", shape_params(1, 1024, 4, 5),
         8, 4, staged, {}),
        # native p32 (N=4096 is phase 11's)
        ("native p32 k=1 N=2048 l=3 b=7 n=8", shape_params(1, 2048, 3, 7),
         8, 4, batches, {}),
    ]
    for label, params, steps, limbs, sizes, forced in cases:
        for batch in sizes:
            dev = kernel_inputs(params, steps, batch, limbs, True, seed=5)
            plain = fbr.blind_rotate_k1_plain(*dev, params)
            plans = [(None, None, None)] + forced.get(batch, [])
            for cb, cluster, nw in plans:
                plan = fbr.k1_device_plan(batch, params, dev[0].device,
                                          limbs, cb, cluster, nw)
                fit = fbr.k1_max_clusters(plan, limbs)
                stages, smem = fbr.k1_layout(plan, limbs)
                got = fbr.blind_rotate_k1(*dev, params, batch_tile=cb,
                                          cluster=cluster, nw=nw)
                torch.cuda.synchronize()
                err = int((got.long() - plain.long()).abs().max())
                report("k1", f"{label} B={batch} plan cb={plan.cb} "
                       f"cluster={plan.cluster} nw={plan.nw} "
                       f"stages={stages} smem={smem} "
                       f"({'default' if cb is None else 'forced'}; "
                       f"{fit} clusters fit at once)", err, worst)
            del dev, plain


def check_k2(fbr, presets, worst: dict) -> None:
    """Phase 3, K2: bitwise against its plain version on the card, at the
    plans k2_plan picks and at forced (tile, cluster) plans."""
    import torch

    aes = presets["aes128_p4"][0]
    test = presets["test"][0]
    every = [(cb, c) for cb in fbr.K2_TILES for c in fbr.k2_clusters(aes)]
    # (label, params, steps, limbs, batches, forced (cb, cluster) at batch)
    cases = [
        ("test", test, test.lwe_dim, 4, (21,),
         {21: [(cb, None) for cb in fbr.K2_TILES]}),
        ("aes128_p4 n=8", aes, 8, 4, (21, 64, 512, 1024, 2048),
         {1024: every}),
        ("aes128_p4 n=8 bsk_limbs=3", aes, 8, 3, (21, 64, 512, 1024, 2048),
         {}),
        ("p16 n=8", presets["p16"][0], 8, 4, (21, 512, 1024), {}),
        # the staged families, which --orientation fused sends to K2
        ("fam1 k=1 N=1024 l=3 b=6 n=8", shape_params(1, 1024, 3, 6), 8, 4,
         STAGED_K2, {}),
        ("fam2 k=2 N=512 l=4 b=5 n=8", shape_params(2, 512, 4, 5), 8, 4,
         STAGED_K2, {}),
        ("kreyvium fam1 k=1 N=1024 l=4 b=5 n=8", shape_params(1, 1024, 4, 5),
         8, 4, STAGED_K2, {}),
    ]
    for label, params, steps, limbs, batches, forced in cases:
        for batch in batches:
            dev = kernel_inputs(params, steps, batch, limbs, False, seed=6)
            plain = fbr.blind_rotate_k2_plain(*dev, params)
            plans = [(None, None)] + forced.get(batch, [])
            for cb, cluster in plans:
                plan = fbr.device_plan(batch, params, dev[0].device, limbs,
                                       cb, cluster)
                fit = fbr.k2_max_clusters(plan, limbs)
                got = fbr.blind_rotate_k2(*dev, params, batch_tile=cb,
                                          cluster=cluster)
                torch.cuda.synchronize()
                err = int((got.long() - plain.long()).abs().max())
                report("k2", f"{label} B={batch} plan cb={plan.cb} "
                       f"cluster={plan.cluster} stages={plan.stages} "
                       f"({'default' if cb is None else 'forced'}; "
                       f"{fit} clusters fit at once)", err, worst)
            del dev, plain


def check_kernels(fbr, presets) -> dict:
    """Phase 3: each kernel bitwise against its plain version."""
    worst = {"k1": 0, "k2": 0}
    check_k1(fbr, presets, worst)
    check_k2(fbr, presets, worst)
    return worst


def bound_ms(params, steps: int, batch: int, keys) -> tuple[float, str]:
    """The least time the card could take for one fused blind rotation:
    the larger of its int8 operations (2 per MAC of the digits [B, rows·N]
    by every step's [rows·N, L·(k+1)·N] key matrix) over the int8 peak and
    its bytes (keys, b_init, a_t and test polynomials read once, ACC written
    once) over the memory rate; and which of the two it is."""
    k1, N = params.glwe_dim + 1, params.poly_size
    rows_n = k1 * params.bsk_level * N
    limbs = (keys.shape[1] // k1 if keys.ndim == 4
             else keys.shape[1] // (k1 * N))
    ops = 2 * steps * batch * rows_n * limbs * k1 * N
    nbytes = (keys.numel() + 4 * (batch + steps * batch + batch * N)
              + 4 * k1 * batch * N)
    t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return ((t_ops, "operations") if t_ops >= t_bytes
            else (t_bytes, "bytes"))


def check_bootstrap(presets, worst: dict) -> dict:
    """Phase 4: the fast FBS through each kernel against the generic FBS at
    aes128_p4, then each kernel's time beside its plain version's at one
    main-path level's shape, the two outputs bitwise equal (their
    difference goes into ``worst``)."""
    import numpy as np
    import torch
    from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import (
        functional_bootstrap_fast, prepare_fast_keys)
    from tfhe_fbs_map_tpu_torch.tfhe import (build_test_vector,
                                             decrypt_values, encrypt_values,
                                             functional_bootstrap,
                                             generate_keys)

    params = presets["aes128_p4"][0]
    dev = torch.device("cuda")
    with timed("keygen aes128_p4"):
        keys = generate_keys(params, seed=7, device=dev)
    rng = np.random.default_rng(8)
    table = [0, 1, 1, 0, 1]
    values = rng.integers(0, len(table), 64)
    cts = encrypt_values(keys, values, rng)
    tv, post = build_test_vector(table, params)
    tvs = torch.from_numpy(np.tile(tv, (64, 1))).to(dev)
    posts = torch.full((64,), post, dtype=torch.int32, device=dev)
    with timed("generic FBS, batch 64"):
        want = functional_bootstrap(keys, cts, tvs, posts)
    if not np.array_equal(decrypt_values(keys, want),
                          np.asarray(table)[values]):
        raise SystemExit("generic FBS decrypts wrong")

    timing = {}
    N = params.poly_size
    for orient, kern in (("fused", "k2"), ("fused_otf", "k1")):
        with timed(f"prepare_fast_keys {orient}"):
            fast = prepare_fast_keys(keys, orientation=orient)
        with timed(f"FBS through {kern}, batch 64"):
            got = functional_bootstrap_fast(fast, cts, tvs, posts)
        if not torch.equal(got, want):
            raise SystemExit(f"FBS through {kern} != generic FBS")
        log(f"  FBS through {kern} ({orient}) bitwise equal to the generic "
            f"FBS at aes128_p4, batch 64")
        # one main-path level: LEVEL_BATCH ciphertexts, all n steps
        g = torch.Generator(device=dev).manual_seed(9)
        b_init = torch.randint(0, 2 * N, (LEVEL_BATCH, 1), generator=g,
                               device=dev, dtype=torch.int32)
        a_t = torch.randint(0, 2 * N, (params.lwe_dim, LEVEL_BATCH, 1),
                            generator=g, device=dev, dtype=torch.int32)
        tv_l = tvs[:1].expand(LEVEL_BATCH, N).contiguous()
        kfn = fbr.blind_rotate_k1 if kern == "k1" else fbr.blind_rotate_k2
        pfn = (fbr.blind_rotate_k1_plain if kern == "k1"
               else fbr.blind_rotate_k2_plain)
        k_ms, k_out = cuda_ms(lambda: kfn(b_init, a_t, tv_l,
                                          fast.bsk_kernels, params), REPS)
        p_ms, p_out = cuda_ms(lambda: pfn(b_init, a_t, tv_l,
                                          fast.bsk_kernels, params), 1)
        b_ms, b_by = bound_ms(params, params.lwe_dim, LEVEL_BATCH,
                              fast.bsk_kernels)
        timing[kern] = (k_ms, p_ms, b_ms, b_by)
        err = int((k_out.long() - p_out.long()).abs().max())
        worst[kern] = max(worst[kern], err)
        plan = (fbr.k1_device_plan if kern == "k1"
                else fbr.device_plan)(LEVEL_BATCH, params, dev)
        log(f"  {kern} at aes128_p4, n={params.lwe_dim}, B={LEVEL_BATCH} "
            f"({plan}): {'bitwise equal' if err == 0 else 'MISMATCH'} "
            f"to its plain version (max_abs_err {err}); kernel "
            f"{k_ms:.3f} ms, plain version {p_ms:.3f} ms, bound "
            f"{b_ms:.3f} ms ({b_by})")
        if err or not torch.equal(k_out, p_out):
            raise SystemExit(f"{kern} disagrees with its plain version at "
                             f"the main path's level shape")
        del k_out, p_out
        del fast
        torch.cuda.empty_cache()
    return timing


def check_staged_launches(fbr, worst: dict) -> list[dict]:
    """Phase 4, K1 at each staged main path's family launch at full length
    (its own n, k, N, l and ciphertexts) against its plain version on the
    same inputs, bitwise, with both times and the bound."""
    import torch

    rows = []
    for label, (k, N, l, b), steps, batch in STAGED_LAUNCHES:
        params = shape_params(k, N, l, b)
        dev = kernel_inputs(params, steps, batch, 4, True, seed=10)
        k_ms, k_out = cuda_ms(lambda: fbr.blind_rotate_k1(*dev, params), 1)
        p_ms, p_out = once_ms(lambda: fbr.blind_rotate_k1_plain(*dev, params))
        b_ms, b_by = bound_ms(params, steps, batch, dev[3])
        err = int((k_out.long() - p_out.long()).abs().max())
        report("k1", f"{label} n={steps} k={k} N={N} l={l} b={b} B={batch} "
               f"({fbr.k1_device_plan(batch, params, dev[0].device)}): "
               f"kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, bound "
               f"{b_ms:.3f} ms ({b_by})", err, worst)
        rows.append({"launch": label, "n": steps, "ciphertexts": batch,
                     "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        del dev, k_out, p_out
        torch.cuda.empty_cache()
    return rows


# phase 11 (a): K1 at N=4096 (k=1, l=2, b=8): the checks' steps and
# ciphertexts (533 leaves a ragged last tile), then one launch at full
# length, as a (1, 4096) family of the optimizer's grid runs it
N4096 = (1, 4096, 2, 8)
N4096_STEPS = 8
N4096_BATCHES = (64, 512, 2048, 533)
N4096_FULL = (700, 512)


def check_k1_4096(fbr, worst: dict) -> list[dict]:
    """Phase 11 (a): K1 at N=4096 bitwise against its plain version on the
    card, at the plan k1_plan picks for each batch at 4 and 3 limbs, then at
    full length (n=700, 512 ciphertexts) with both times and the bound."""
    import torch

    params = shape_params(*N4096)
    for batch in N4096_BATCHES:
        for limbs in (4, 3):
            dev = kernel_inputs(params, N4096_STEPS, batch, limbs, True,
                                seed=13)
            plain = fbr.blind_rotate_k1_plain(*dev, params)
            got = fbr.blind_rotate_k1(*dev, params)
            torch.cuda.synchronize()
            plan = fbr.k1_device_plan(batch, params, dev[0].device, limbs)
            stages, smem = fbr.k1_layout(plan, limbs)
            report("k1", f"k=1 N=4096 l=2 b=8 n={N4096_STEPS} limbs={limbs} "
                   f"B={batch} plan cb={plan.cb} cluster={plan.cluster} "
                   f"nw={plan.nw} stages={stages} smem={smem}",
                   int((got.long() - plain.long()).abs().max()), worst)
            del dev, plain, got
    steps, batch = N4096_FULL
    dev = kernel_inputs(params, steps, batch, 4, True, seed=14)
    k_ms, k_out = cuda_ms(lambda: fbr.blind_rotate_k1(*dev, params), 1)
    p_ms, p_out = once_ms(lambda: fbr.blind_rotate_k1_plain(*dev, params))
    b_ms, b_by = bound_ms(params, steps, batch, dev[3])
    err = int((k_out.long() - p_out.long()).abs().max())
    report("k1", f"k=1 N=4096 l=2 b=8 full length n={steps} B={batch} "
           f"({fbr.k1_device_plan(batch, params, dev[0].device)}): kernel "
           f"{k_ms:.3f} ms, plain version {p_ms:.3f} ms, bound {b_ms:.3f} ms "
           f"({b_by})", err, worst)
    del dev, k_out, p_out
    torch.cuda.empty_cache()
    return [{"launch": "k=1 N=4096 l=2 b=8", "n": steps,
             "ciphertexts": batch, "max_abs_err": err, "ms": k_ms,
             "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}]


def entry_point(main, argv: list, launches: dict) -> tuple[int, dict, dict]:
    """``main(argv)`` of an entry point, as a user calls it, with the launch
    counts set to 0 just before and read just after; returns its exit code,
    its last line's JSON and the counts."""
    import torch

    for k in launches:
        launches[k] = 0
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    counts = dict(launches)
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    log(f"  {' '.join(argv)} -> rc {rc} in {time.time() - t0:.1f} s")
    log(f"  {json.dumps(res)}")
    log(f"  kernel launches in this run: {counts}")
    return rc, res, counts


def run_cli(argv: list, expect: str, launches: dict) -> dict:
    """The runtime CLI, required bit-exact and to have launched ``expect``;
    returns its JSON line with the launches of ``expect``."""
    from tfhe_fbs_map_tpu_torch.runtime.cli import main as cli_main

    rc, res, counts = entry_point(cli_main, argv, launches)
    if rc != 0 or not res["bit_exact"]:
        raise SystemExit(f"main path ({' '.join(argv)}) not bit-exact")
    if counts[expect] == 0:
        raise SystemExit(f"main path ({' '.join(argv)}) never launched "
                         f"{expect}")
    res["launches"] = counts[expect]
    res["all_launches"] = counts
    return res


def run_main_path(orientation: str, expect: str, launches: dict) -> dict:
    """Phase 5: mapped AES-128 through the runtime CLI."""
    return run_cli([AES_LBF, "--params", "aes128_p4", "--batch", "8",
                    "--orientation", orientation], expect, launches)


def run_staged_path(launches: dict) -> dict:
    """Phase 6, the runtime CLI on Kreyvium-1152 at the staged preset with
    the default ``--orientation auto``: both families on K1, bit-exact, and
    K1 launched once for every non-empty family call of the staged plan
    (none of K2)."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.runtime.executor import compile_staged
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS

    preset = STAGED_PRESETS[KREYVIUM_PRESET]
    with open(ROOT / KREYVIUM_LBF) as f:
        plan = compile_staged(parse_lbf(f.read()), preset.p, preset.fam1,
                              preset.fam2)
    calls = sum(bool(lv.wire_idx1.shape[0]) + bool(lv.wire_idx2.shape[0])
                for lv in plan.levels)
    res = run_cli([KREYVIUM_LBF, "--params", KREYVIUM_PRESET, "--batch",
                   str(KREYVIUM_BATCH), "--orientation", "auto"], "k1",
                  launches)
    if res["orientation"] != {"fam1": "fused_otf", "fam2": "fused_otf"}:
        raise SystemExit(f"staged auto picked {res['orientation']}")
    log(f"  staged plan: {len(plan.levels)} levels, {calls} non-empty "
        f"family calls, routes {plan.route_counts}")
    if res["launches"] != calls or res["all_launches"]["k2"]:
        raise SystemExit(f"staged main path launched {res['all_launches']}, "
                         f"want k1 once per family call ({calls})")
    return res


def run_bench(launches: dict) -> dict:
    """Phase 6, the port's staged p32 bench at its default batch: errors 0,
    and K1 launched twice (fam1, fam2) a step, first step included."""
    from tfhe_fbs_map_tpu_torch import bench

    rc, res, counts = entry_point(bench.main, ["--preset", "p32"], launches)
    want = 2 * (1 + bench.ITERS)
    if rc != 0 or res["errors"] != 0:
        raise SystemExit(f"p32 bench: rc {rc}, {res['errors']} errors")
    if counts["k1"] != want or counts["k2"]:
        raise SystemExit(f"p32 bench launched {counts}, want k1 {want}")
    res["launches"] = counts["k1"]
    return res


KERNEL = {"fused": "k2", "fused_otf": "k1"}
# phase 7: (label, program, batch); the error target that makes a run of
# ~166k bootstraps bit-exact (the 4-sigma default expects ~10 flips)
OPTIMIZER_RUNS = (("aes128 optimizer", AES_LBF, 8),
                  ("kreyvium optimizer", KREYVIUM_LBF, KREYVIUM_BATCH))
P_ERROR = 1e-7


def check_pick(fbr, pick, sizes: list[list[int]], worst: dict) -> list[str]:
    """Phase 7, before a run: the kernel the cost model prices for each
    picked family must be ``pick_orientations``' on the card, and its plan
    and waves ``k1_device_plan`` / ``device_plan``'s at every launch size
    of the run; and each picked family's kernel is held against its plain
    version at n=8 at those sizes (phase 3 checks fixed shapes; the
    optimizer may pick others).  Returns the orientations."""
    import torch
    from tfhe_fbs_map_tpu_torch.optimizer.optimizer import h100_profile
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import launch_plan
    from tfhe_fbs_map_tpu_torch.runtime.cli import pick_orientations

    dev = torch.device("cuda")
    profile = h100_profile()
    model = [profile.kernel(f.lwe_dim, f.glwe_dim, f.poly_size, f.bsk_level,
                            pick.bsk_limbs, pick.staged)
             for f in pick.families]
    card = pick_orientations(list(pick.families), dev,
                             bsk_limbs=pick.bsk_limbs)
    if model != card:
        raise SystemExit(f"the cost model prices {model}, the card's "
                         f"--orientation auto runs {card}")
    limbs = pick.bsk_limbs
    for params, orient, rows_list in zip(pick.families, model, sizes):
        kern = KERNEL[orient]
        otf = kern == "k1"
        waves = set()
        for rows in sorted(set(rows_list)):
            plan, w = launch_plan(params, rows, orient, limbs)
            got = (fbr.k1_device_plan if otf else fbr.device_plan)(
                rows, params, dev, limbs)
            fit = (fbr.k1_max_clusters if otf else fbr.k2_max_clusters)(
                got, limbs)
            tiles = -(-rows // got.cb)
            got_w = -(-tiles // max(1, fit))
            if (plan, w) != (got, got_w):
                raise SystemExit(f"{kern} at {rows} ciphertexts: the model "
                                 f"plans {plan} in {w} waves, the card "
                                 f"{got} in {got_w}")
            waves.add((rows, w))
        log(f"  {kern} for n={params.lwe_dim} k={params.glwe_dim} "
            f"N={params.poly_size} l={params.bsk_level} b="
            f"{params.bsk_base_log} at {limbs} limbs: model plans and waves "
            f"equal the card's at {len(waves)} launch sizes "
            f"{sorted(waves)}")
        shell = shape_params(params.glwe_dim, params.poly_size,
                             params.bsk_level, params.bsk_base_log)
        for batch in sorted(set(rows_list)):
            dev_args = kernel_inputs(shell, 8, batch, limbs, otf, seed=11)
            plain = (fbr.blind_rotate_k1_plain if otf
                     else fbr.blind_rotate_k2_plain)(*dev_args, shell)
            got = (fbr.blind_rotate_k1 if otf
                   else fbr.blind_rotate_k2)(*dev_args, shell)
            torch.cuda.synchronize()
            report(kern, f"picked family k={shell.glwe_dim} "
                   f"N={shell.poly_size} l={shell.bsk_level} "
                   f"b={shell.bsk_base_log} n=8 limbs={limbs} B={batch}",
                   int((got.long() - plain.long()).abs().max()), worst)
            del dev_args, plain, got
    return model


def run_optimizer(label: str, lbf: str, batch: int, fbr, worst: dict,
                  staged: str = "auto", fbs_size: int | None = None) -> dict:
    """The runtime CLI on ``lbf`` with the optimizer's picks, as a user runs
    it with no ``--params`` (and ``--staged staged``, ``--fbs_size`` where
    given): the picks checked against the card first (:func:`check_pick`),
    then the run required bit-exact, on the families picked, and to launch
    the priced kernel once for every family call."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.runtime.cli import family_json, optimizer_pick
    from tfhe_fbs_map_tpu_torch.runtime.executor import (compile_staged,
                                                         native_level_boots,
                                                         staged_level_routes)
    from tfhe_fbs_map_tpu_torch.optimizer.runtime_model import bucket

    with open(ROOT / lbf) as f:
        prog = parse_lbf(f.read())
    p = fbs_size or prog.fbs_size or prog.min_fbs_size()
    pick = optimizer_pick(prog, p, batch, staged, P_ERROR)
    if pick.staged:
        routes = staged_level_routes(prog, p)
        fam_calls = ([(ns, f1) for ns, f1, _ in routes],
                     [(ns, f2) for ns, _, f2 in routes])
        sizes = [[bucket(ns + nf) * batch for ns, nf in fc if ns + nf]
                 for fc in fam_calls]
        plan = compile_staged(prog, p, *pick.families)
        calls = sum(bool(lv.wire_idx1.shape[0])
                    + bool(lv.wire_idx2.shape[0]) for lv in plan.levels)
    else:
        sizes = [[bucket(nb) * batch for nb in native_level_boots(prog)]]
        calls = len(sizes[0])
    route = "staged" if pick.staged else "native"
    log(f"  {label}: route {route} (runtime model per evaluation: "
        f"native {pick.native_us} us, staged {pick.staged_us} us), "
        f"bsk_limbs {pick.bsk_limbs}, p_error {pick.p_error}, "
        f"families {[family_json(f) for f in pick.families]}")
    orients = check_pick(fbr, pick, sizes, worst)
    kern = KERNEL[orients[0]]
    res = run_cli([lbf, "--batch", str(batch), "--p-error", str(P_ERROR),
                   "--staged", staged]
                  + (["--fbs_size", str(fbs_size)] if fbs_size else []),
                  kern, fbr.LAUNCHES)
    want = ({"fam1": orients[0], "fam2": orients[1]} if pick.staged
            else orients[0])
    fams = ({"fam1": family_json(pick.families[0]),
             "fam2": family_json(pick.families[1])} if pick.staged
            else family_json(pick.families[0]))
    if (res["params_from"] != "optimizer" or res["staged"] != pick.staged
            or res["orientation"] != want or res["params"] != fams
            or res["bsk_limbs"] != pick.bsk_limbs):
        raise SystemExit(f"{label}: the CLI ran {res['params']} "
                         f"({res['orientation']}), the optimizer picked "
                         f"{fams} ({want})")
    if res["launches"] != calls or sum(res["all_launches"].values()) \
            != calls:
        raise SystemExit(f"{label} launched {res['all_launches']}, want "
                         f"{kern} once per family call ({calls})")
    log(f"  {label} via {kern}: run_s {res['run_s']}, predicted "
        f"{res['predicted_run_s']}, boots_per_sec "
        f"{res['boots_per_sec']}, {res['launches']} launches")
    return res


def run_optimizer_path(fbr, worst: dict) -> list[tuple[str, dict]]:
    """Phase 7: both programs with the optimizer's picks."""
    return [(label, run_optimizer(label, lbf, batch, fbr, worst))
            for label, lbf, batch in OPTIMIZER_RUNS]


# phase 8: the bench's kernel launches at full length, (preset, kernel), at
# the bench's default batch; anchor on both kernels, the rest on auto's
BENCH_BATCH = 512
BENCH_LAUNCHES = (("anchor", "k2"), ("anchor", "k1"), ("p8", "k2"),
                  ("p16", "k2"), ("p32", "k1"))
# the bench runs: (label, arguments, the kernel its JSON must name, key
# limbs dropped).  A dropped limb puts the anchor's bootstraps far outside
# its noise budget (the noise model's p_error 0.12 a bootstrap; the JAX
# bench measured 63/512 wrong at its r1 anchor), so that run is held to
# report its errors and exit 1 on them, not to 0 errors.
BENCH_RUNS = (
    ("bench anchor", ["--preset", "anchor"], "k2", 0),
    ("bench anchor fused_otf", ["--preset", "anchor", "--orientation",
                                "fused_otf"], "k1", 0),
    ("bench anchor bsk_limbs=3", ["--preset", "anchor", "--bsk-limbs", "3"],
     "k2", 1),
    ("bench p8", ["--preset", "p8"], "k2", 0),
    ("bench p16", ["--preset", "p16"], "k2", 0),
    ("bench p32 native", ["--preset", "p32", "--native-p32"], "k1", 0),
)
# the 16x16 multiplier, mapped by the port's CLI (944 bootstraps), then run
# with the optimizer's picks
C6288R = "benchmarks/iscas85/c6288r.bench"
C6288R_LBF = "build/c6288r_4_search_opt.lbf"
C6288R_BOOTSTRAPS = 944
C6288R_BATCH = 64


def check_bench_launches(fbr, presets, worst: dict) -> dict:
    """Phase 8: each kernel at the bench's launches (every step of the
    preset, the bench's batch) against its plain version on the same
    inputs, bitwise, with both times and the bound; rows by kernel."""
    import torch

    rows = {"k1": [], "k2": []}
    for preset, kern in BENCH_LAUNCHES:
        params = presets[preset][0]
        otf = kern == "k1"
        steps = params.lwe_dim
        dev = kernel_inputs(params, steps, BENCH_BATCH, 4, otf, seed=12)
        kfn = fbr.blind_rotate_k1 if otf else fbr.blind_rotate_k2
        pfn = fbr.blind_rotate_k1_plain if otf else fbr.blind_rotate_k2_plain
        k_ms, k_out = cuda_ms(lambda: kfn(*dev, params), REPS)
        p_ms, p_out = once_ms(lambda: pfn(*dev, params))
        b_ms, b_by = bound_ms(params, steps, BENCH_BATCH, dev[3])
        err = int((k_out.long() - p_out.long()).abs().max())
        plan = (fbr.k1_device_plan if otf else fbr.device_plan)(
            BENCH_BATCH, params, dev[0].device)
        report(kern, f"bench {preset} n={steps} k={params.glwe_dim} "
               f"N={params.poly_size} l={params.bsk_level} "
               f"b={params.bsk_base_log} B={BENCH_BATCH} ({plan}): kernel "
               f"{k_ms:.3f} ms, plain version {p_ms:.3f} ms, bound "
               f"{b_ms:.3f} ms ({b_by})", err, worst)
        if not torch.equal(k_out, p_out):
            raise SystemExit(f"{kern} disagrees with its plain version at "
                             f"the bench's {preset} launch")
        rows[kern].append({"launch": f"bench {preset}", "n": steps,
                           "ciphertexts": BENCH_BATCH, "max_abs_err": err,
                           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                           "bound_by": b_by})
        del dev, k_out, p_out
        torch.cuda.empty_cache()
    return rows


def run_benches(smi: str, presets, launches: dict) -> dict:
    """Phase 8, the bench's native presets through ``bench.main`` at their
    defaults: the kernel the JSON names launched 1 + iters times and the
    other never; errors 0 on full keys, and on a dropped limb the errors
    reported beside the noise model's rate, with exit code 1.  Returns the
    launches of each run by label."""
    import torch
    from tfhe_fbs_map_tpu_torch import bench
    from tfhe_fbs_map_tpu_torch.optimizer.noise import p_error_atomic

    out = {}
    want = 1 + bench.ITERS
    for label, argv, kern, dropped in BENCH_RUNS:
        torch.cuda.empty_cache()
        rc, res, counts = entry_point(bench.main, argv, launches)
        other = "k1" if kern == "k2" else "k2"
        if rc != (1 if res["errors"] else 0) or (not dropped
                                                 and res["errors"]):
            raise SystemExit(f"{label}: rc {rc}, {res['errors']} errors")
        if KERNEL[res["orientation"]] != kern or counts[kern] != want \
                or counts[other] or res["bsk_limbs"] != 4 - dropped:
            raise SystemExit(f"{label} ran {res['orientation']} at "
                             f"{res['bsk_limbs']} limbs and launched "
                             f"{counts}, want {kern} {want} times")
        log(f"  {label} via {kern}: {res['value']} boots/s, "
            f"{res['ms_per_bootstrap']} ms a bootstrap (batch "
            f"{res['batch']}, bsk_limbs {res['bsk_limbs']}, keygen "
            f"{res['keygen_s']} s, {counts[kern]} launches) on {smi}")
        if dropped:
            params = presets[argv[1]][0]
            rate = p_error_atomic(
                params.p, 1, params.lwe_dim, params.glwe_dim,
                params.poly_size, params.bsk_level, params.bsk_base_log,
                params.ksk_level, params.ksk_base_log,
                params.lwe_noise_std, params.glwe_noise_std, dropped)
            log(f"  {label}: {res['errors']} wrong of {2 * res['batch']} "
                f"checked (the noise model's p_error {rate:.3f} a "
                f"bootstrap at {4 - dropped} limbs), rc {rc}")
        out[label] = (kern, counts[kern])
    torch.cuda.empty_cache()
    return out


def map_c6288r() -> None:
    """Phase 8: c6288r mapped at p=4 with ``--opt`` by the port's own CLI
    into ``build/``; its stats line must count the reference's 944
    bootstraps."""
    import ast
    from tfhe_fbs_map_tpu_torch.frontend.cli import main as map_main

    (ROOT / C6288R_LBF).parent.mkdir(exist_ok=True)
    argv = [str(ROOT / C6288R), "--type", "bench", "--fbs_size", "4",
            "--opt", "--output_lbf", str(ROOT / C6288R_LBF)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = map_main(argv)
    stats = ast.literal_eval(out.getvalue().strip().splitlines()[-1])
    log(f"  frontend.cli {C6288R} --fbs_size 4 --opt -> rc {rc}: "
        f"{stats['nb_bootstrap']} bootstraps, norm2 "
        f"{stats['norm2_linprod']}, mapped in {stats['time']:.2f} s")
    if rc != 0 or stats["nb_bootstrap"] != C6288R_BOOTSTRAPS:
        raise SystemExit(f"c6288r mapped to {stats['nb_bootstrap']} "
                         f"bootstraps (rc {rc}), want {C6288R_BOOTSTRAPS}")


# phase 9: ciphertexts of the sharded FBS at the anchor (512 a shard, the
# bench's launch); AES-128's batch through the mesh executor (8 a shard, the
# batch of phase 5); the staged dry run's batch; the two ranks' timeout each
MESH_FBS_BATCH = 1024
MESH_AES_BATCH = 16
MESH_STAGED_BATCH = 4
RANK_TIMEOUT = 300
# a rank of phase 9 (d): the runtime CLI's main, then its launch counts
RANK = ("import json, sys\n"
        "from tfhe_fbs_map_tpu_torch.ops.fused_blind_rotate import LAUNCHES\n"
        "from tfhe_fbs_map_tpu_torch.runtime.cli import main\n"
        "rc = main(sys.argv[1:])\n"
        "print('# launches ' + json.dumps(LAUNCHES), file=sys.stderr)\n"
        "sys.exit(rc)\n")


def card_mesh():
    """Two dp positions on the one card."""
    from tfhe_fbs_map_tpu_torch.parallel import make_mesh
    return make_mesh(["cuda"] * 2)


def want_launches(kern: str, n: int) -> dict:
    return {kern: n, "k2" if kern == "k1" else "k1": 0}


def check_mesh_fbs(presets) -> dict:
    """Phase 9 (a): ``sharded_bootstrap`` on two shards of the card at the
    anchor, through each kernel: bitwise equal to the one-device launch,
    with 2 launches of the kernel and none of the other."""
    import torch
    from tfhe_fbs_map_tpu_torch.parallel import dryrun

    out = {}
    for orient, kern in (("fused_otf", "k1"), ("fused", "k2")):
        t0 = time.time()
        res = dryrun.sharded_fbs(card_mesh(), presets["anchor"][0], orient,
                                 MESH_FBS_BATCH)
        log(f"  sharded FBS at anchor, {MESH_FBS_BATCH} ciphertexts on 2 "
            f"shards via {kern}: bit_exact {res['bit_exact']}, launches "
            f"{res['launches']} ({time.time() - t0:.1f} s)")
        if not res["bit_exact"] or res["launches"] != want_launches(kern, 2):
            raise SystemExit(f"sharded FBS via {kern}: {res}")
        out[kern] = res["launches"][kern]
        torch.cuda.empty_cache()
    return out


def run_mesh_aes(presets, smi: str) -> dict:
    """Phase 9 (b): AES-128 at batch 16 through the mesh executor on two
    shards (K1), against the same run on one device."""
    import numpy as np
    import torch
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
    from tfhe_fbs_map_tpu_torch.parallel import dryrun
    from tfhe_fbs_map_tpu_torch.tfhe import generate_keys

    with open(ROOT / AES_LBF) as f:
        prog = parse_lbf(f.read())
    mesh = card_mesh()
    keys = generate_keys(presets["aes128_p4"][0], seed=42,
                         device=mesh.devices[0])
    fast = prepare_fast_keys(keys, orientation="fused_otf")
    rng = np.random.default_rng(42)
    values = {n.name: rng.integers(0, 2, MESH_AES_BATCH)
              for n in prog.nodes if n.kind == "input"}
    res = dryrun.mesh_against_one_device(mesh, prog, keys, fast, values, 43,
                                         prog.eval(values))
    log(f"  AES-128, batch {MESH_AES_BATCH}: 2 shards run_s "
        f"{res['run_s']:.3f}, one device {res['one_s']:.3f} s; bit_exact "
        f"{res['bit_exact']}, launches {res['launches']} on {smi}")
    if not res["bit_exact"] or res["launches"] != want_launches(
            "k1", 2 * res["calls"]):
        raise SystemExit(f"mesh AES-128: {res}")
    del keys, fast
    torch.cuda.empty_cache()
    return res


def run_mesh_staged(presets) -> dict:
    """Phase 9 (c): the dry run's staged p=32 program at the p32_staged
    families on two shards through K1, against one device."""
    from tfhe_fbs_map_tpu_torch.parallel import dryrun
    from tfhe_fbs_map_tpu_torch.tfhe.params import STAGED_PRESETS

    preset = STAGED_PRESETS["p32_staged"]
    res = dryrun.staged_p32(card_mesh(), preset.fam1, preset.fam2,
                            "fused_otf", MESH_STAGED_BATCH)
    log(f"  staged p32 dry run on 2 shards: bit_exact {res['bit_exact']}, "
        f"{res['calls']} family calls, launches {res['launches']}")
    if not res["bit_exact"] or res["launches"] != want_launches(
            "k1", 2 * res["calls"]):
        raise SystemExit(f"mesh staged p32: {res}")
    return res


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_two_processes(smi: str) -> dict:
    """Phase 9 (d): the runtime CLI as two processes over gloo on the one
    card, ``--mesh auto``: rank 0 alone prints the line, bit-exact with dp
    2; each rank launches K1 once a level.  The kernels are built already,
    so no rank runs nvcc."""
    import torch

    torch.cuda.empty_cache()
    argv = [AES_LBF, "--params", "aes128_p4", "--orientation", "fused_otf",
            "--batch", "8", "--mesh", "auto"]
    port = str(free_port())
    procs = []
    t0 = time.time()
    try:
        for rank in range(2):
            env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": port, "WORLD_SIZE": "2",
                   "RANK": str(rank)}
            env.setdefault("GLOO_SOCKET_IFNAME", "lo")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK, *argv], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    counts = []
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in err.splitlines() if ln.startswith("# launches ")]
        if p.returncode != 0 or not lines:
            raise SystemExit(f"rank {rank} exited {p.returncode}:\n{err}")
        counts.append(json.loads(lines[-1][len("# launches "):]))
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    log(f"  2 processes, {' '.join(argv)} -> rc 0 and 0 in "
        f"{time.time() - t0:.1f} s")
    log(f"  {json.dumps(res)}")
    log(f"  kernel launches by rank: {counts}; run_s {res['run_s']} on "
        f"{smi}")
    if (res["mesh"] != {"dp": 2, "tp": 1} or not res["bit_exact"]
            or outs[1][0].strip()
            or any(c != want_launches("k1", res["levels"]) for c in counts)):
        raise SystemExit("the 2-process run: want dp 2, bit-exact, rank 0's "
                         "line alone and K1 once a level in each rank")
    res["launches"] = [c["k1"] for c in counts]
    return res


def run_bench_multichip(smi: str, launches: dict) -> dict:
    """Phase 9 (e): ``bench_multichip`` at its defaults: errors 0, K1 (its
    default) launched once a call a position, 1 + iters calls."""
    import torch
    from tfhe_fbs_map_tpu_torch import bench_multichip

    torch.cuda.empty_cache()
    rc, res, counts = entry_point(bench_multichip.main, [], launches)
    if rc != 0 or res["errors"] or counts != want_launches(
            "k1", res["dp"] * (1 + bench_multichip.ITERS)):
        raise SystemExit(f"bench_multichip: rc {rc}, {res}, {counts}")
    log(f"  bench_multichip: {res['value']} boots/s over dp={res['dp']} "
        f"({res['boots_per_sec_per_chip']} a position, "
        f"{res['batch_per_chip']} ciphertexts a position), errors 0, on "
        f"{smi}")
    res["launches"] = counts["k1"]
    return res


# phase 10: (label, program, preset, batch, orientation or "auto", dp); the
# row whose two runs go under torch.profiler for the device's idle share
GRAPH_PROFILED = "aes128_p4 fused_otf"
GRAPH_RUNS = (
    ("aes128_p4 fused_otf", AES_LBF, "aes128_p4", 8, "fused_otf", 1),
    ("aes128_p4 auto", AES_LBF, "aes128_p4", 8, "auto", 1),
    (f"{KREYVIUM_PRESET} auto", KREYVIUM_LBF, KREYVIUM_PRESET, KREYVIUM_BATCH,
     "auto", 1),
    ("aes128_p4 fused_otf dp=2", AES_LBF, "aes128_p4", MESH_AES_BATCH,
     "fused_otf", 2),
)


def graph_executor(lbf: str, preset: str, batch: int, orientation: str,
                   dp: int):
    """The executor, input buffer and family calls of a phase-10 run, made
    as the runtime CLI makes them (keys from seed 42, ``auto`` by
    ``pick_orientations``, inputs from ``default_rng(42)``)."""
    import numpy as np
    import torch
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.ops.blind_rotate import prepare_fast_keys
    from tfhe_fbs_map_tpu_torch.runtime.cli import pick_orientations
    from tfhe_fbs_map_tpu_torch.runtime.executor import CircuitExecutor
    from tfhe_fbs_map_tpu_torch.tfhe import generate_keys
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS, STAGED_PRESETS
    from tfhe_fbs_map_tpu_torch.tfhe.staged import generate_staged_keys

    with open(ROOT / lbf) as f:
        prog = parse_lbf(f.read())
    dev = torch.device("cuda", torch.cuda.current_device())
    if preset in STAGED_PRESETS:
        pre = STAGED_PRESETS[preset]
        keys = generate_staged_keys(pre.p, pre.fam1, pre.fam2, seed=42,
                                    device=dev)
        families = [keys.keys1, keys.keys2]
    else:
        keys = generate_keys(PRESETS[preset][0], seed=42, device=dev)
        families = [keys]
    orients = (pick_orientations([k.params for k in families], dev)
               if orientation == "auto" else [orientation] * len(families))
    fast = [prepare_fast_keys(k, orientation=o)
            for k, o in zip(families, orients)]
    ex = CircuitExecutor(prog, keys, fast_keys=tuple(fast) if len(fast) > 1
                         else fast[0], mesh=card_mesh() if dp > 1 else None)
    rng = np.random.default_rng(42)
    values = {n.name: rng.integers(0, 2, batch)
              for n in prog.nodes if n.kind == "input"}
    buf = ex.encrypt_inputs(values, rng)
    calls = (sum(bool(lv.wire_idx1.shape[0]) + bool(lv.wire_idx2.shape[0])
                 for lv in ex.levels) if ex.staged else len(ex.levels))
    return ex, buf, dp * calls, KERNEL[orients[0]], prog.eval(values)


def eager_run(ex, buf):
    """The level loop ``run`` walks with a checkpoint: one ``step`` a level
    on every shard."""
    shards = [s.clone() for s in (buf if isinstance(buf, list) else [buf])]
    for lv in range(len(ex.levels)):
        shards = [ex.step(s, lv) for s in shards]
    return shards if isinstance(buf, list) else shards[0]


def share(x) -> str:
    """An idle share, or "not measured" where the profiler saw no device
    activity."""
    return "not measured" if x is None else f"{x:.4f}"


def run_graphs(smi: str, launches: dict) -> list[dict]:
    """Phase 10: each of GRAPH_RUNS once as the graph replay and then once
    as the eager level loop, each run's wall seconds between two
    synchronisations (for GRAPH_PROFILED both runs under ``torch.profiler``,
    with the device's idle share over the whole run), and the capture's
    seconds; the launches of each run (equal, one a family call a position)
    and the final wire buffers (bitwise equal, and bit-exact).  The graph
    runs first: the capture's warm-up builds the plan tensors and the
    library workspaces, which the eager loop then finds built too, so both
    timed runs are warm."""
    import numpy as np
    import torch
    from tfhe_fbs_map_tpu_torch.runtime.profile import trace_run

    rows = []
    for label, lbf, preset, batch, orientation, dp in GRAPH_RUNS:
        torch.cuda.empty_cache()
        ex, buf, calls, kern, oracle = graph_executor(lbf, preset, batch,
                                                      orientation, dp)
        dev = ex.device
        got = {}
        runs = {"eager": lambda: got.setdefault("eager", eager_run(ex, buf)),
                "graph": lambda: got.setdefault("graph", ex.run(buf))}
        profiled = label == GRAPH_PROFILED
        secs, idle, counts = {}, {}, []
        torch.cuda.synchronize()
        for kind in ("graph", "eager"):
            if kind == "graph":
                t0 = time.time()
                graphs = ex.capture(buf)
                torch.cuda.synchronize()
                capture_s = time.time() - t0
            for k in launches:
                launches[k] = 0
            if profiled:
                traced = trace_run(dev, runs[kind])
                secs[kind] = traced["wall_s"]
                idle[kind] = traced["idle_share"]
            else:
                torch.cuda.synchronize()
                t0 = time.time()
                runs[kind]()
                torch.cuda.synchronize()
                secs[kind] = time.time() - t0
            counts.append(dict(launches))
        outs = {kind: (b if isinstance(b, list) else [b])
                for kind, b in got.items()}
        same = all(torch.equal(a, b) for a, b in zip(outs["eager"],
                                                      outs["graph"]))
        dec = ex.decrypt_outputs(got["graph"])
        exact = all(np.array_equal(np.asarray(v), dec[k])
                    for k, v in oracle.items())
        want = want_launches(kern, calls)
        idle_txt = (f"under the profiler, device idle eager "
                    f"{share(idle['eager'])}, graph {share(idle['graph'])}"
                    if profiled else "not profiled")
        log(f"  {label}, batch {batch}: eager run_s {secs['eager']:.3f}, "
            f"graph {secs['graph']:.3f} ({idle_txt}); capture "
            f"{capture_s:.3f} s ({graphs} graphs, {len(ex.groups)} "
            f"groups); buffers {'bitwise equal' if same else 'DIFFER'}, "
            f"bit_exact {exact}; launches {counts} on {smi}")
        if not same or not exact or any(c != want for c in counts):
            raise SystemExit(f"phase 10 {label}: graph and eager disagree "
                             f"or launched {counts}, want {want}")
        rows.append({"label": label, "kernel": kern, "launches": calls,
                     "eager_run_s": secs["eager"],
                     "graph_run_s": secs["graph"], "profiled": profiled,
                     "capture_s": capture_s, "graphs": graphs,
                     "groups": len(ex.groups), "idle_share": idle})
        del ex, buf, got, outs, runs
    torch.cuda.empty_cache()
    return rows


# phase 11 (b): the sweep's runs, (suite, benchmarks, sizes); (c): the batch
# its programs run at (the sweep's RT_BATCH), and the program run staged,
# native and auto
SWEEP_RUNS = (("iscas85", ["c17", "c432r"], "3,4"),
              ("iscas89", ["s9234r"], "22"))
SWEEP_BATCH = 16
SWEEP_STAGED = ("s9234r", 22)
SWEEP_COLUMNS = ("boot_cost", "total_cost", "native_rt_est", "staged_rt_est")


def finite(x) -> bool:
    return isinstance(x, (int, float)) and x == x and abs(x) != float("inf")


def run_sweeps(root: Path) -> list[dict]:
    """Phase 11 (b): ``harness.sweep`` as a user runs it, into ``root``;
    every row needs a finite ``boot_cost`` and ``native_rt_est`` (s9234r at
    p=22 also ``staged_rt_est``), printed beside the committed TPU row of
    the same (bench, p, mapper), the reference's."""
    from tfhe_fbs_map_tpu_torch.harness import sweep

    rows = []
    for suite, benches, sizes in SWEEP_RUNS:
        argv = ["--suite", suite, "--bench", *benches, "--sizes", sizes,
                "--root", str(root)]
        t0 = time.time()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = sweep.main(argv)
        priced = [ln for ln in out.getvalue().splitlines()
                  if ln.startswith("priced ")]
        log(f"  harness.sweep {' '.join(argv[:-2])} -> rc {rc} in "
            f"{time.time() - t0:.1f} s; {'; '.join(priced)}")
        if rc:
            raise SystemExit(f"harness.sweep {' '.join(argv)}: rc {rc}")
        tpu = {(r["bench"], r["fbs_size"], r["mapper"]): r
               for r in sweep.read_rows(ROOT / "outputs"
                                        / f"{suite}_agg_est.csv")}
        for r in sweep.read_rows(root / suite / f"{suite}_agg_est.csv"):
            key = (r["bench"], r["fbs_size"], r["mapper"])
            need = ["boot_cost", "native_rt_est"] + (
                ["staged_rt_est"] if key[:2] == SWEEP_STAGED else [])
            if not all(finite(r.get(k)) for k in need):
                raise SystemExit(f"sweep row {key}: {need} not all finite: "
                                 f"{r}")
            ref = tpu.get(key, {})
            log(f"  {key[0]} p={key[1]} {key[2]}: {r['nb_bootstrap']} "
                f"bootstraps, norm2 {r['norm2_linprod']}"
                + (" (the H100 row priced at the least p its tables "
                   "need, the TPU row at the label's p=2)"
                   if key[2] == "basic" else ""))
            for k in SWEEP_COLUMNS:
                log(f"    {k:<14} H100 (this run) {r.get(k, '-')!s:>12}   "
                    f"TPU (the reference's, committed) "
                    f"{ref.get(k, '-') if ref else 'no row'}")
            rows.append(r)
    return rows


def run_sweep_programs(rows: list[dict], root: Path, fbr, worst: dict,
                       smi: str) -> list[tuple[str, dict]]:
    """Phase 11 (c): each program the sweep wrote through the runtime CLI
    at SWEEP_BATCH with the optimizer's picks at ``--p-error 1e-7``
    (:func:`run_optimizer`: bit-exact, the priced kernel once a family
    call), s9234r at p=22 ``--staged on``, ``off`` and ``auto``; each JSON
    line saved under ``root/runs`` and the analysis tables printed over
    them and the sweep's aggregates.  Each run's ``run_s`` is printed
    against the sweep's estimate of it: the row priced again by
    ``add_estimates`` at the run's error target, whose ``*_rt_est`` of the
    route taken must be the CLI's ``predicted_run_s`` within 1%.  A
    ``basic`` baseline is labelled p=2 (the reference's convention) while
    its 2-input gates' tables need a larger p: the sweep prices it and it
    runs at the least p that realizes them, ``--fbs_size`` as a user passes
    it."""
    from tfhe_fbs_map_tpu_torch.frontend.lut_program import parse_lbf
    from tfhe_fbs_map_tpu_torch.harness import analyse, sweep

    runs = []
    (root / "runs").mkdir()
    estimates = [dict(r) for r in rows]
    sweep.add_estimates(estimates, root / "runs_estimated.csv",
                        p_error=P_ERROR)
    for r, est in zip(rows, estimates):
        lbf = r["output_lbf"]
        stem = Path(lbf).stem
        with open(lbf) as f:
            prog = parse_lbf(f.read())
        p_min = prog.min_fbs_size()
        fbs_size = p_min if p_min > (prog.fbs_size or 0) else None
        if fbs_size:
            log(f"  {stem}: its tables need p={p_min} (the .lbf says "
                f"p={prog.fbs_size}), run with --fbs_size {p_min}")
        modes = (("on", "off", "auto")
                 if (r["bench"], r["fbs_size"]) == SWEEP_STAGED
                 else ("auto",))
        got = {}
        for mode in modes:
            label = f"sweep {stem} staged={mode}"
            res = run_optimizer(label, lbf, SWEEP_BATCH, fbr, worst, mode,
                                fbs_size)
            got[mode] = res
            runs.append((label, res))
            col = "staged_rt_est" if res["staged"] else "native_rt_est"
            if not finite(est[col]) or res["predicted_run_s"] is None:
                raise SystemExit(f"{label}: no {col} from the sweep "
                                 f"({est[col]!r}) or no CLI prediction")
            est_s = est[col] * SWEEP_BATCH / 1e6
            log(f"  {label}: run_s {res['run_s']} against the sweep's "
                f"{col} at p_error {P_ERROR}, {est[col]} us an evaluation "
                f"= {est_s:.6f} s at batch {SWEEP_BATCH} (run_s / sweep "
                f"{res['run_s'] / est_s:.3f}); the CLI predicted "
                f"{res['predicted_run_s']}; on {smi}")
            if abs(est_s / res["predicted_run_s"] - 1) > 0.01:
                raise SystemExit(f"{label}: the sweep prices the run at "
                                 f"{est_s} s, the CLI at "
                                 f"{res['predicted_run_s']} s")
            name = stem if mode == "auto" else f"{stem}_{mode}"
            (root / "runs" / f"{name}.json").write_text(
                json.dumps({k: v for k, v in res.items()
                            if k not in ("launches", "all_launches")}))
        if len(got) == 3:
            staged_s, native_s = got["on"]["run_s"], got["off"]["run_s"]
            faster = "staged" if staged_s < native_s else "native"
            took = "staged" if got["auto"]["staged"] else "native"
            log(f"  {stem} at batch {SWEEP_BATCH}: staged run_s {staged_s} "
                f"(predicted {got['on']['predicted_run_s']}), native "
                f"{native_s} (predicted {got['off']['predicted_run_s']}); "
                f"native / staged {native_s / staged_s:.3f}; auto routed "
                f"{took} (run_s {got['auto']['run_s']}), the faster was "
                f"{faster}: routing took the faster: {took == faster}; on "
                f"{smi}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        analyse.main([str(root / s / f"{s}_agg_est.csv")
                      for s, _, _ in SWEEP_RUNS]
                     + ["--measured", str(root / "runs")])
    for line in out.getvalue().splitlines():
        log(f"  {line}")
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="stop after the kernel checks")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "tfhe_fbs_map_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    # --- 1. the card -----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {smi}")
    log(f"[torch] {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")

    from tfhe_fbs_map_tpu_torch.ops import _build
    from tfhe_fbs_map_tpu_torch.ops import fused_blind_rotate as fbr
    from tfhe_fbs_map_tpu_torch.tfhe.params import PRESETS

    # --- 2. build --------------------------------------------------------
    t0 = time.time()
    lib = _build.build()
    _build.library()
    log(f"[build] {lib.name} in {time.time() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "smem", "warning")):
            log(f"  ptxas: {line.strip()}")

    # --- 3. kernels against their plain versions ---------------------------
    t0 = time.time()
    worst = check_kernels(fbr, PRESETS)
    log(f"[kernel checks] {time.time() - t0:.1f} s")
    if args.quick:
        return 0

    # --- 4. bootstrap through each kernel, and kernel times ----------------
    t0 = time.time()
    timing = check_bootstrap(PRESETS, worst)
    staged_k1 = check_staged_launches(fbr, worst)
    log(f"[bootstrap checks] {time.time() - t0:.1f} s")

    # --- 5. the main path ----------------------------------------------------
    t0 = time.time()
    runs = {"k2": run_main_path("auto", "k2", fbr.LAUNCHES),
            "k1": run_main_path("fused_otf", "k1", fbr.LAUNCHES)}
    for kern, res in runs.items():
        log(f"  main path via {kern}: run_s {res['run_s']} boots_per_sec "
            f"{res['boots_per_sec']} ({res['bootstraps']} bootstraps x "
            f"batch {res['batch']}, {res['levels']} levels) on {smi}")
    log(f"[main path] {time.time() - t0:.1f} s")

    # --- 6. the staged main path ---------------------------------------------
    t0 = time.time()
    krey = run_staged_path(fbr.LAUNCHES)
    log(f"  staged Kreyvium-1152 via k1: run_s {krey['run_s']} "
        f"boots_per_sec {krey['boots_per_sec']} ({krey['bootstraps']} "
        f"bootstraps x batch {krey['batch']}, {krey['levels']} levels, "
        f"{krey['launches']} K1 launches) on {smi}")
    p32 = run_bench(fbr.LAUNCHES)
    log(f"  staged p32 bench via k1: {p32['value']} boots/s, "
        f"{p32['ms_per_bootstrap']} ms a lookup (batch {p32['batch']}, "
        f"{p32['launches']} K1 launches) on {smi}")
    log(f"[staged main path] {time.time() - t0:.1f} s")

    # --- 7. the optimizer path -------------------------------------------------
    t0 = time.time()
    opt_runs = run_optimizer_path(fbr, worst)
    from tfhe_fbs_map_tpu_torch.optimizer import validate
    rows = [validate.row(label, res) for label, res in (
        ("aes128_p4 auto", runs["k2"]), ("aes128_p4 fused_otf", runs["k1"]),
        (f"{KREYVIUM_PRESET} auto", krey), *opt_runs)]
    log("  runtime model, predicted against measured run_s, on " + smi)
    for line in validate.table(rows).splitlines():
        log(f"  {line}")
    log(f"  {sum(r['within'] for r in rows)}/{len(rows)} within "
        f"[{validate.LOW}, {validate.HIGH}]")
    log(f"[optimizer path] {time.time() - t0:.1f} s")

    # --- 8. the bench and a mapped ISCAS85 program ---------------------------
    t0 = time.time()
    bench_k = check_bench_launches(fbr, PRESETS, worst)
    benches = run_benches(smi, PRESETS, fbr.LAUNCHES)
    map_c6288r()
    c6288r = run_optimizer("c6288r optimizer", C6288R_LBF, C6288R_BATCH, fbr,
                           worst)
    log(f"  c6288r (mapped by the port's CLI) via "
        f"{c6288r['orientation']}: run_s {c6288r['run_s']}, predicted "
        f"{c6288r['predicted_run_s']}, boots_per_sec "
        f"{c6288r['boots_per_sec']} ({c6288r['bootstraps']} bootstraps x "
        f"batch {c6288r['batch']}, {c6288r['levels']} levels) on {smi}")
    log(f"[bench and c6288r] {time.time() - t0:.1f} s")

    # --- 9. the dp mesh, two shards on the one card --------------------------
    t0 = time.time()
    log("  two positions on one card: slicing, launches and reassembly are "
        "checked; no scaling is measured")
    mesh_fbs = check_mesh_fbs(PRESETS)
    mesh_aes = run_mesh_aes(PRESETS, smi)
    mesh_staged = run_mesh_staged(PRESETS)
    two = run_two_processes(smi)
    multichip = run_bench_multichip(smi, fbr.LAUNCHES)
    log(f"[mesh] {time.time() - t0:.1f} s")

    # --- 10. CUDA graphs against the eager level loop ------------------------
    t0 = time.time()
    graph_rows = run_graphs(smi, fbr.LAUNCHES)
    log(f"[graphs] {time.time() - t0:.1f} s")

    # --- 11. K1 at N=4096; the sweep priced on the H100, and its programs ----
    t0 = time.time()
    n4096 = check_k1_4096(fbr, worst)
    with tempfile.TemporaryDirectory() as tmp:
        sweep_rows = run_sweeps(Path(tmp))
        sweep_runs = run_sweep_programs(sweep_rows, Path(tmp), fbr, worst,
                                        smi)
    log(f"[harness] {time.time() - t0:.1f} s")

    # launches of each kernel on every main path, each counted from 0
    by_path = {"k2": {"aes128_p4 auto": runs["k2"]["launches"]},
               "k1": {"aes128_p4 fused_otf": runs["k1"]["launches"],
                      f"{KREYVIUM_PRESET} auto": krey["launches"],
                      "bench p32": p32["launches"]}}
    for label, (kern, n) in benches.items():
        by_path[kern][label] = n
    for label, res in opt_runs + [("c6288r optimizer", c6288r)] \
            + sweep_runs:
        for kern, n in res["all_launches"].items():
            if n:
                by_path[kern][label] = n
    for kern, n in mesh_fbs.items():
        by_path[kern]["mesh sharded FBS anchor dp=2"] = n
    by_path["k1"].update({
        "mesh aes128_p4 fused_otf dp=2": mesh_aes["launches"]["k1"],
        "mesh staged p32 dry run dp=2": mesh_staged["launches"]["k1"],
        "2 processes aes128_p4 rank 0": two["launches"][0],
        "2 processes aes128_p4 rank 1": two["launches"][1],
        "bench_multichip": multichip["launches"]})
    for row in graph_rows:
        by_path[row["kernel"]][f"graphs {row['label']}"] = row["launches"]
    log(json.dumps({"graphs": graph_rows}))
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[kern],
         "replaces": REPLACES[kern], "launches": sum(by_path[kern].values()),
         "launches_by_path": by_path[kern],
         "max_abs_err": worst[kern], "ms": timing[kern][0],
         "plain_ms": timing[kern][1], "bound_ms": timing[kern][2],
         "bound_by": timing[kern][3], "library_ms": None,
         **({"staged_launches": staged_k1, "n4096_launches": n4096}
            if kern == "k1" else {}),
         "bench_launches": bench_k[kern]}
        for kern, name in (("k2", "fused_blind_rotate_k2"),
                           ("k1", "fused_blind_rotate_k1"))]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
