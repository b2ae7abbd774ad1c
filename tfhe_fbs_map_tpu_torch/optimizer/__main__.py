"""The parameter optimizer's command line, with H100 costs.

    python -m tfhe_fbs_map_tpu_torch.optimizer --precision 9 --sq-norm2 14

Prints one solution row in the JAX package's format, ending in ``..., cost,
p_error``: the cost is µs per bootstrap on the calibrated H100.
"""

import argparse
import sys

from .noise import P_ERROR_4_SIGMA
from .optimizer import format_solution_line, optimize

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", type=int, required=True,
                    help="bootstrapping precision: # plaintext values")
    ap.add_argument("--sq-norm2", type=float, default=1,
                    help="maximal squared norm2 of linear products")
    ap.add_argument("--p-error", type=float, default=P_ERROR_4_SIGMA)
    ap.add_argument("--allow-slow-path", action="store_true",
                    help="accepted as the JAX package's CLI accepts it")
    args = ap.parse_args()

    sol = optimize(args.precision, args.sq_norm2, max_p_error=args.p_error,
                   fast_path_only=not args.allow_slow_path)
    if sol is None:
        print(f"# no solution for precision={args.precision} "
              f"sq_norm2={args.sq_norm2}", file=sys.stderr)
        sys.exit(1)
    print(format_solution_line(sol))
