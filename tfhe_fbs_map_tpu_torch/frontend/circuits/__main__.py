"""Emit the generated benchmark suite as BLIF files.

Equivalent of ``python experiments/generate_benchmarks.py --prefix DIR``
(reference ``generate_benchmarks.py:450-496``) and of ``python -m
tfhe_fbs_map_tpu.frontend.circuits``, byte for byte.  The three
``trivium_state`` variants are excluded from the default emission set,
matching the reference's run list (``generate_benchmarks.py:472-474``).
The output directory is always the caller's: ``--out DIR`` (or the JAX
module's ``--prefix DIR``).
"""

import argparse
import os

from .generators import BENCH_GENERATORS, build_bench

DEFAULT_SET = [n for n in BENCH_GENERATORS if not n.startswith("trivium_state")]

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Generate benchmark BLIFs")
    parser.add_argument("--out", "--prefix", dest="out", required=True,
                        help="output directory")
    parser.add_argument("--bench", nargs="*", default=DEFAULT_SET,
                        help="benchmark names (default: full suite)")
    args = parser.parse_args()

    os.makedirs(args.out, exist_ok=True)
    for name in args.bench:
        circ = build_bench(name)
        with open(os.path.join(args.out, f"{name}.blif"), "w") as f:
            circ.to_blif(fs=f, model_name=name)
        print(f"{name}: {circ.stats()}")
