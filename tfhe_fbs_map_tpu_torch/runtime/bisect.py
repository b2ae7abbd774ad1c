"""Where a fused kernel's time goes: its CUDA source with one phase left out,
timed.

    python -m tfhe_fbs_map_tpu_torch.runtime.bisect \\
        [--params aes128_p4] [--batch 1024] [--reps 2] [--out bisect.json]
    python -m tfhe_fbs_map_tpu_torch.runtime.bisect \\
        --params kreyvium_p10_staged.fam1 --batch 3200
    python -m tfhe_fbs_map_tpu_torch.runtime.bisect --kernel k1s \\
        [--reps 20] [--out bisect.json]

Builds one library per variant of a kernel's source with ``nvcc`` (all at
once, into ``build/``), then times each variant's launch on the same random
operands (CUDA events, after a warm-up launch; for the small-N kernel also
as the replay of a CUDA graph of the launches, ``graph_ms``: its sub-ms
launches can outrun the host's launch path).

``--kernel k1`` (the default) bisects ``ops/csrc/fused_blind_rotate.cu`` at
the full n steps of a preset or of a staged preset's family
(``<staged preset>.fam1`` or ``.fam2``, :func:`shapes`), at the plans the
card picks with one tile a cluster and with two in turns (``k1_kernel``,
``k1_kernel_pair``; labels ``<cb>x<cluster>/<nw>`` and ``... pair``) and
at the 128-ciphertext plan ``128x8/32``.  The variants:

* ``base``: the source as it is;
* ``no_products``: the product warpgroups issue no ``wgmma``;
* ``no_h_copy``: the producer issues no copy of H blocks from the keys'
  table, and the consumers wait for none;
* ``no_products_no_h_copy``: both;
* ``no_digits``: no digit pass (neither schedule's);
* ``no_epilogue``: no ACC epilogue after a column chunk's products: the
  product warps still sum the limbs (so the products stay) but store
  nothing into the staging buffer, and no reduce-add adds it into ACC; the
  handshakes between them, the fences and the cluster signals stay.

``--kernel k1s`` bisects K1's small-N kernel,
``ops/csrc/fused_blind_rotate_k1_small.cu``, at the five full-length
launches of :func:`small_n_launches` and, on its small-tile plan at N =
512, at the AES-128 family's launches of 16 and 128 ciphertexts on each
tile and cluster it is built for (:func:`wide_launches`).  The variants:

* ``base``: the source as it is;
* ``no_products``: no ``mma.sync`` (and so none of its operand loads:
  the B windows and the A fragments);
* ``no_key_copy``: the step's key rows are not brought into shared memory
  (nor waited for);
* ``no_digits``: the digit pass stores no digit (and so computes none; at
  N = 512 reads no span of the ACC from another CTA either);
* ``mma_only``: the products' ``mma.sync`` on operands from registers;
* ``loads_only``: the products' shared loads, no ``mma.sync``;
* ``no_exchange``: a CTA stores its span of ACC (at N = 512 its digits)
  into its own copy only;
* ``local_only``: that, and CTA barriers in place of the step's cluster
  barriers (at N = 512 also its ACC words read from itself).

Only ``base`` computes the blind rotation; the others are timed only (their
outputs are compared with ``base`` and reported, not required).  Needs a
CUDA device and ``nvcc``.  Prints the card's name and power limit, then one
JSON object as its last line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

PRODUCTS = "sl != 0 || k != 0);"
H_COPY = ("    mbar_expect_tx(rg.hfull + 8 * s, St::kH);\n"
          "    for (int lb = 0; lb < L; ++lb)\n"
          "      bulk_load(rg.smem0 + s * St::kBytes + St::kA + lb * St::kHB "
          "* 128,\n"
          "                h0 + lb * limb_stride, St::kHB * 128, "
          "rg.hfull + 8 * s);\n")
H_WAIT = ("    mbar_wait_or_give_up(rg.hfull + 8 * s, (G / kS) & 1, "
          "stuck);\n")
# the digit pass of either schedule (the single-tile kernel's consumers',
# the paired kernel's digit warpgroup's)
DIGITS = r"digit_pass<CB, true[^;]*;"
# the ACC epilogue of a column chunk, edit by edit: the product warps'
# stores of its limb-summed accumulators into the staging buffer, kept
# only under a condition that random sums meet with odds 2^-32 (ptxas
# drops a wgmma whose sums nothing reads), and the reduce-add of the
# buffer into ACC; the staged / freed handshakes stay
EPILOGUE = ((r"(st_shared_v2\([^;]*\);)", r"if (v0 == ~v1) \1"),
            (r"tma_reduce_add\([^;]*\);", "(void)0;"))

# The small-N kernel's phases: the edits of each variant, every one of
# which must apply to exactly one statement (or to one in each place the
# count names: a B window's load is in k1s_kernel's product loop and in
# products()' per-tile one, the A fragment's ldmatrix in both of
# products()' loops, the key copy in both kernels).  mma_only and
# loads_only split
# the products into their mma.sync (operands from registers) and their
# shared loads (kept alive by an xor); no_exchange and local_only take out
# the exchange of ACC over the cluster.
K1S_PHASES = {
    "no_products": [(r"mma_s8\(d\[rt\]\[lb\]\[nt\], a\[rt\],[^;]*\);",
                     "(void)0;", 2),
                    (r"mma_s8\(d\[lb\]\[nt\],[^;]*\);", "(void)0;")],
    "no_key_copy": [(r"mbar_expect_tx\([^;]*\);", "(void)0;", 2),
                    (r"bulk_load\([^;]*\);", "(void)0;", 2),
                    (r"mbar_wait\([^;]*\);", "(void)0;", 2)],
    "no_digits": [(r"dp\[lev \* \(n / 4\)\] = packed;", "(void)0;"),
                  (r"store_to\(at, peer, p0, p1\);", "(void)0;")],
    "mma_only": [(r"window\(stage \+ lb \* lstride,\s*bo\[0\] \+ ko "
                  r"\+ 8 \* m\)", "static_cast<uint32_t>(ko + m)", 2),
                 (r"window\(er, bo\[nt\] \+ ko \+ 16\)",
                  "static_cast<uint32_t>(bo[nt] + ko + 16)", 2),
                 (r"window\(er, bo\[nt\] \+ ko\)",
                  "static_cast<uint32_t>(bo[nt] + ko)", 2),
                 (r"ldmatrix_x4\(a, a_lane \+ 32 \* kc\);",
                  "a[0] = kc; a[1] = kc + 1; a[2] = kc + 2; a[3] = kc + 3;"),
                 (r"ldmatrix_x4\(a\[rt\], a_lane \+ rt \* a_rt \+ 32 \* kc\);",
                  "{ a[rt][0] = kc; a[rt][1] = a[rt][2] = a[rt][3] = rt; }",
                  2)],
    "loads_only": [(r"mma_s8\(d\[rt\]\[lb\]\[nt\], a\[rt\], bw\[lb\]\[nt\], "
                    r"bw\[lb\]\[nt \+ 2\]\);",
                    "d[rt][lb][nt][0] ^= a[rt][0] ^ a[rt][1] ^ a[rt][2] ^ "
                    "a[rt][3] ^ bw[lb][nt] ^ bw[lb][nt + 2];"),
                   (r"mma_s8\(d\[rt\]\[lb\]\[nt\], a\[rt\], "
                    r"bw\[nt\]\[lb\]\[0\], bw\[nt\]\[lb\]\[1\]\);",
                    "d[rt][lb][nt][0] ^= a[rt][0] ^ a[rt][1] ^ a[rt][2] ^ "
                    "a[rt][3] ^ bw[nt][lb][0] ^ bw[nt][lb][1];"),
                   (r"mma_s8\(d\[lb\]\[nt\], a, bw\[nt\]\[lb\]\[0\], "
                    r"bw\[nt\]\[lb\]\[1\]\);",
                    "d[lb][nt][0] ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ "
                    "bw[nt][lb][0] ^ bw[nt][lb][1];")],
    "no_exchange": [(r"for \(int j = 0; j < cluster; \+\+j\) \{",
                     "for (int j = 0; j < 1; ++j) {", 2)],
    "local_only": [(r"for \(int j = 0; j < cluster; \+\+j\) \{",
                    "for (int j = 0; j < 1; ++j) {", 2),
                   (r"(= next_amt;\s*)cluster_barrier\(\);",
                    r"\1__syncthreads();"),
                   (r"(every read of a span done\s*)cluster_barrier\(\);",
                    r"\1__syncthreads();"),
                   (r"(every CTA done with its digits\s*)cluster_barrier\(\);",
                    r"\1__syncthreads();"),
                   (r"src - owner \* span\), owner\)",
                    "src - owner * span), rank)")],
}
K1S_SOURCE = "fused_blind_rotate_k1_small.cu"


def _products(src: str) -> str:
    """The ``wgmma_s8...(...)`` statement of the consumers' slice loop."""
    end = src.index(PRODUCTS) + len(PRODUCTS)
    return src[src.rindex("wgmma_s8", 0, end):end]


def variants(src: str) -> dict[str, str]:
    """The K1 source with each phase left out; raises if the source no
    longer has the statements the variants remove."""
    mma = _products(src)
    for anchor in (H_COPY, H_WAIT):
        if src.count(anchor) != 1:
            raise ValueError(f"K1 source has no unique {anchor[:40]!r}")
    if len(re.findall(DIGITS, src)) != 2:
        raise ValueError("K1 source has not two digit passes")
    if any(len(re.findall(pat, src)) != 1 for pat, _ in EPILOGUE):
        raise ValueError("K1 source has no unique ACC epilogue")
    no_epilogue = src
    for pat, repl in EPILOGUE:
        no_epilogue = re.sub(pat, repl, no_epilogue)
    no_h_copy = src.replace(H_COPY, "").replace(H_WAIT, "")
    return {
        "base": src,
        "no_products": src.replace(mma, "(void)0;"),
        "no_h_copy": no_h_copy,
        "no_products_no_h_copy": no_h_copy.replace(mma, "(void)0;"),
        "no_digits": re.sub(DIGITS, "(void)0;", src),
        "no_epilogue": no_epilogue,
    }


def k1s_variants(src: str) -> dict[str, str]:
    """The small-N kernel's source with each phase left out; raises if the
    source no longer has a statement a variant removes."""
    out = {"base": src}
    for name, edits in K1S_PHASES.items():
        text = src
        for pat, repl, *count in edits:
            if len(re.findall(pat, src)) != (count or [1])[0]:
                raise ValueError(f"small-N source: {name} finds no unique "
                                 f"{pat!r}")
            text = re.sub(pat, repl, text)
        out[name] = text
    return out


def _build_all(srcs: dict[str, str], file_name: str,
               parts: tuple[str, ...]) -> dict[str, ctypes.CDLL]:
    from ..ops import _build

    root = _build.BUILD_DIR / "bisect"
    with ThreadPoolExecutor(len(srcs)) as pool:
        def one(name):
            src = root / name / file_name
            src.parent.mkdir(parents=True, exist_ok=True)
            src.write_text(srcs[name])
            so = src.with_name("kernel.so")
            _build.compile_library([src], so)
            return _build.bind(so, parts)
        return dict(zip(srcs, pool.map(one, srcs)))


def timed_ms(call, reps: int) -> float:
    """Mean ms of ``reps`` launches of ``call``, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(call, reps: int, replays: int = 3) -> float:
    """Mean ms a launch of ``call`` on the device alone: ``reps`` launches
    captured in one CUDA graph, one warm-up replay, then ``replays``
    replays timed with CUDA events (a sub-ms launch issued eagerly may
    wait on the host's launch path instead)."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(reps):
            call()
    graph.replay()
    torch.cuda.synchronize()
    return timed_ms(graph.replay, replays) / reps


def bisect(params, batch: int, reps: int, seed: int = 9) -> dict:
    """ms per launch of K1's ring kernel of every variant at the plans the
    card picks with one tile a cluster and with two, and at 128x8/32."""
    from ..ops import _build
    from ..ops import fused_blind_rotate as fbr

    b_init, a_t, tvs, keys = operands(params, batch, seed)
    table = fbr.hankel_table(keys)  # the keys' own, built once
    src = (_build.CSRC / "fused_blind_rotate.cu").read_text()
    libs = _build_all(variants(src), "fused_blind_rotate.cu", ("k1",))
    picked = fbr.k1_device_plan(batch, params, torch.device("cuda"),
                                route="k1", lib=libs["base"])
    plans = {}
    for pair in fbr.K1_PAIRS:
        p = fbr.k1_device_plan(batch, params, torch.device("cuda"),
                               route="k1", lib=libs["base"], pair=pair)
        plans[f"{p.cb}x{p.cluster}/{p.nw}{' pair' * (pair == 2)}"] = \
            p._asdict()
    plans.setdefault("128x8/32", dict(cb=128, cluster=8, nw=32, pair=1))
    res, ref = {}, {}
    for name, lib in libs.items():
        for label, kw in plans.items():
            def call():
                return fbr._launch_k1(b_init, a_t, tvs, keys, params,
                                      kw["cb"], kw["cluster"], kw["nw"], lib,
                                      hankel=lambda: table, pair=kw["pair"])
            out = call()
            torch.cuda.synchronize()
            ref.setdefault(label, out)
            res[f"{name} {label}"] = {
                "ms": timed_ms(call, reps),
                "equal_to_base": bool(torch.equal(out, ref[label]))}
    return {"batch": batch, "steps": params.lwe_dim,
            "picked": picked._asdict(), "variants": res}


def small_n_launches() -> list[tuple]:
    """K1's small-N launches at full length, (label, params, ciphertexts),
    read from the modules whose main paths make them: the dry run's FBS (8
    a position), ``bench --quick``'s chain, the p32 quick bench's fam2 (5
    lookups x 8 ciphertexts), ``bench_multichip --quick`` (16 a position,
    its cap) and, last, its family at the scaling study's
    ``--batch-per-chip`` default of 48."""
    from .. import bench, bench_multichip
    from ..parallel.dryrun import DRYRUN_PARAMS
    from ..tfhe.params import STAGED_PRESETS

    fam2 = STAGED_PRESETS["staged_test"].fam2
    return [("dry run FBS", DRYRUN_PARAMS, 8),
            ("bench --quick", bench.QUICK_PARAMS,
             bench.QUICK_BATCH["native"]),
            ("bench p32 --quick fam2", fam2,
             bench.LANES * bench.QUICK_BATCH["staged"]),
            ("bench_multichip --quick", bench_multichip.QUICK_PARAMS, 16),
            ("bench_multichip --quick family at 48",
             bench_multichip.QUICK_PARAMS, 48)]


def wide_launches() -> list[tuple]:
    """K1's small-tile launches at N = 512, (label, params, ciphertexts):
    the AES-128 family at one evaluation's level sizes 16 and 128 (the
    ``aes128_p4.b1`` cell's launches, packed, are 4 to 176 ciphertexts,
    192 of them of at most 112, one wave of tiles of 16)."""
    from ..tfhe.params import PRESETS

    aes = PRESETS["aes128_p4"][0]
    return [(f"aes128_p4 B={b}", aes, b) for b in (16, 128)]


def operands(params, batch: int, seed: int):
    """Random operands of a full-length K1 launch (n steps, 4 limbs), drawn
    on the card."""
    from ..ops import fused_blind_rotate as fbr

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    k1, N, n = params.glwe_dim + 1, params.poly_size, params.lwe_dim
    rows = k1 * params.bsk_level

    def rand(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    return (rand(0, 2 * N, (batch, 1), torch.int32),
            rand(0, 2 * N, (n, batch, 1), torch.int32),
            rand(-2 ** 31, 2 ** 31, (batch, N), torch.int32),
            rand(-128, 128, (n, fbr.N_LIMBS * k1, rows, 2 * N), torch.int8))


def bisect_small(reps: int, seed: int = 9) -> dict:
    """ms per launch of every variant of the small-N kernel at each launch
    of :func:`small_n_launches` and :func:`wide_launches` (the latter on
    the small-tile plan at every tile and cluster it is built for), eagerly
    and as a graph's replay."""
    from ..ops import _build
    from ..ops import fused_blind_rotate as fbr

    src = (_build.CSRC / K1S_SOURCE).read_text()
    libs = _build_all(k1s_variants(src), K1S_SOURCE, ("k1s",))
    out = [_bisect_launch(libs, label, params, batch, reps, seed)
           for label, params, batch in small_n_launches()]
    for label, params, batch in wide_launches():
        for t in fbr.K1S_WIDE_TILES:
            for c in fbr.k1s_clusters(params, fbr.N_LIMBS, t):
                out.append(_bisect_launch(
                    libs, f"{label} tile {t} cluster {c}", params, batch,
                    reps, seed, c, t))
    return {"kernel": "k1s", "reps": reps, "launches": out}


def _bisect_launch(libs: dict, label: str, params, batch: int, reps: int,
                   seed: int, cluster: int | None = None,
                   tile: int | None = None) -> dict:
    """One launch's row of :func:`bisect_small`: its plan on the card (on
    the small-tile plan's tiles of ``tile`` and ``cluster`` CTAs where
    given) and every variant's ms."""
    from ..ops import fused_blind_rotate as fbr

    args = operands(params, batch, seed)
    route = None if tile is None else "k1s"
    plan = fbr.k1_device_plan(batch, params, torch.device("cuda"),
                              fbr.N_LIMBS, cb=tile, cluster=cluster,
                              lib=libs["base"], route=route)
    row = {"launch": label, "k": params.glwe_dim, "N": params.poly_size,
           "l": params.bsk_level, "b": params.bsk_base_log,
           "n": params.lwe_dim, "ciphertexts": batch,
           "plan": plan._asdict(), "variants": {}}
    base = None
    for name, lib in libs.items():
        def call(lib=lib):
            return fbr._launch_k1(*args, params, tile, cluster, None, lib,
                                  route)
        got = call()
        torch.cuda.synchronize()
        base = got if base is None else base
        row["variants"][name] = {
            "ms": timed_ms(call, reps), "graph_ms": graph_ms(call, reps),
            "equal_to_base": bool(torch.equal(got, base))}
    return row


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def shapes() -> dict:
    """The parameter sets ``--params`` names: every preset, and each
    family of every staged preset as ``<name>.fam1`` and ``<name>.fam2``."""
    from ..tfhe.params import PRESETS, STAGED_PRESETS

    out = {name: p for name, (p, _) in PRESETS.items()}
    for name, st in STAGED_PRESETS.items():
        out.update({f"{name}.fam1": st.fam1, f"{name}.fam2": st.fam2})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("k1", "k1s"), default="k1")
    ap.add_argument("--params", choices=sorted(shapes()),
                    default="aes128_p4",
                    help="k1: the preset whose shape is timed")
    ap.add_argument("--batch", type=int, default=1024,
                    help="k1: ciphertexts a launch")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed launches a variant (k1: 2, k1s: 20)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bisect: needs a CUDA device", file=sys.stderr)
        return 2
    smi = card()
    print(smi, flush=True)
    if args.kernel == "k1s":
        res = bisect_small(args.reps or 20)
    else:
        res = bisect(shapes()[args.params], args.batch, args.reps or 2)
        res["params"] = args.params
    res["device"] = torch.cuda.get_device_name(0)
    res["card"] = smi
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
