"""Where K1's time goes: its CUDA source with one phase left out, timed.

    python -m tfhe_fbs_map_tpu_torch.runtime.bisect \\
        [--params aes128_p4] [--batch 1024] [--reps 2] [--out bisect.json]

Builds one library per variant of ``ops/csrc/fused_blind_rotate.cu`` with
``nvcc`` (all at once, into ``build/``), then times each variant's K1 launch
at the preset's full n steps on the same random operands (CUDA events, after
a warm-up launch), at the plan ``k1_plan`` picks and at the 128-ciphertext
plan ``128x8/32``.  The variants:

* ``base``: the source as it is;
* ``no_products``: the consumers issue no ``wgmma``;
* ``no_build``: the producer writes no H block;
* ``no_products_no_build``: both;
* ``no_digits``: no digit pass.

Only ``base`` computes the blind rotation; the others are timed only (their
outputs are compared with ``base`` and reported, not required).  Needs a
CUDA device and ``nvcc``.  Prints one JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

PRODUCTS = "sl != 0 || k != 0);"
BUILD = "      if (lb < L) {\n        const int w0"
DIGITS = ("    digit_pass<CB, true>(acc, dig, amt[i & 1], g0, q_lo, span, "
          "batch, n, l, b,\n                         K);\n")


def _products(src: str) -> str:
    """The ``wgmma_s8...(...)`` statement of the consumers' slice loop."""
    end = src.index(PRODUCTS) + len(PRODUCTS)
    return src[src.rindex("wgmma_s8", 0, end):end]


def variants(src: str) -> dict[str, str]:
    """The K1 source with each phase left out; raises if the source no
    longer has the statements the variants remove."""
    mma = _products(src)
    no_build = BUILD.replace("lb < L", "lb < 0")
    for anchor in (BUILD, DIGITS):
        if src.count(anchor) != 1:
            raise ValueError(f"K1 source has no unique {anchor[:40]!r}")
    return {
        "base": src,
        "no_products": src.replace(mma, "(void)0;"),
        "no_build": src.replace(BUILD, no_build),
        "no_products_no_build":
            src.replace(mma, "(void)0;").replace(BUILD, no_build),
        "no_digits": src.replace(DIGITS, ""),
    }


def _build_all(srcs: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from ..ops import _build

    root = _build.BUILD_DIR / "bisect"
    with ThreadPoolExecutor(len(srcs)) as pool:
        def one(name):
            src = root / name / "fused_blind_rotate.cu"
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(srcs[name])
            _build.compile_library([src], src.with_name("k1.so"))
            return _build.bind(src.with_name("k1.so"), full=False)
        return dict(zip(srcs, pool.map(one, srcs)))


def bisect(params, batch: int, reps: int, seed: int = 9) -> dict:
    """ms per K1 launch of every variant at two plans."""
    from ..ops import _build
    from ..ops import fused_blind_rotate as fbr

    dev = torch.device("cuda")
    k1, N, n = params.glwe_dim + 1, params.poly_size, params.lwe_dim
    rows = k1 * params.bsk_level
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    b_init = rand(0, 2 * N, (batch, 1), torch.int32)
    a_t = rand(0, 2 * N, (n, batch, 1), torch.int32)
    tvs = rand(-2 ** 31, 2 ** 31, (batch, N), torch.int32)
    keys = rand(-128, 128, (n, fbr.N_LIMBS * k1, rows, 2 * N), torch.int8)
    default = fbr.k1_plan(batch, params, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    plans = {f"{default.cb}x{default.cluster}/{default.nw}":
             default._asdict(),
             "128x8/32": dict(cb=128, cluster=8, nw=32)}
    src = (_build.CSRC / "fused_blind_rotate.cu").read_text()
    libs = _build_all(variants(src))
    res, ref = {}, {}
    for name, lib in libs.items():
        for label, kw in plans.items():
            def call():
                return fbr._launch_k1(b_init, a_t, tvs, keys, params,
                                      kw["cb"], kw["cluster"], kw["nw"], lib)
            out = call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize()
            ref.setdefault(label, out)
            res[f"{name} {label}"] = {
                "ms": start.elapsed_time(end) / reps,
                "equal_to_base": bool(torch.equal(out, ref[label]))}
    return {"batch": batch, "steps": n, "variants": res}


def main(argv=None) -> int:
    from ..tfhe.params import PRESETS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", choices=sorted(PRESETS), default="aes128_p4")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bisect: needs a CUDA device", file=sys.stderr)
        return 2
    res = bisect(PRESETS[args.params][0], args.batch, args.reps)
    res["device"] = torch.cuda.get_device_name(0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
