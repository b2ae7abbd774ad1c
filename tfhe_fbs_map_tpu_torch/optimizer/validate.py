"""The runtime model's predicted ``run_s`` against the measured one.

    python -m tfhe_fbs_map_tpu_torch.optimizer.validate          # on the card
    python -m tfhe_fbs_map_tpu_torch.optimizer.validate runs.jsonl

The port of ``experiments/validate_runtime_model.py``.  Without arguments it
makes the runtime CLI runs ``chip_smoke.py`` makes (:data:`RUNS`: mapped
AES-128 at the ``aes128_p4`` preset through ``auto`` (K1) and through K2,
Kreyvium-1152 at the staged preset, and both programs with the parameters
the optimizer picks at ``--p-error 1e-7``); given files, it reads their JSON
lines (the CLI's last lines).  Each run's line carries the prediction the
CLI made (``predicted_run_s``, from
:func:`.runtime_model.predict_native_us` / ``predict_staged_us`` for the
route and kernels it ran).  Prints a table of predicted against measured
``run_s``, their ratio and whether it falls within [0.75, 1.33], and one
JSON object as the last line.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

__all__ = ["RUNS", "LOW", "HIGH", "row", "table"]

AES_LBF = "outputs/bristol/aes_128_4_search.lbf"
KREYVIUM_LBF = "outputs/generated/kreyvium_stream_v1_10_search.lbf"
# (label, runtime CLI arguments)
RUNS = (
    ("aes128_p4 auto", [AES_LBF, "--params", "aes128_p4", "--batch", "8",
                        "--orientation", "auto"]),
    ("aes128_p4 fused", [AES_LBF, "--params", "aes128_p4", "--batch", "8",
                         "--orientation", "fused"]),
    ("kreyvium_p10_staged auto", [KREYVIUM_LBF, "--params",
                                  "kreyvium_p10_staged", "--batch", "16",
                                  "--orientation", "auto"]),
    ("aes128 optimizer", [AES_LBF, "--batch", "8", "--p-error", "1e-7"]),
    ("kreyvium optimizer", [KREYVIUM_LBF, "--batch", "16", "--p-error",
                            "1e-7"]),
)
# The acceptance band of the prediction's ratio to the measurement.
LOW, HIGH = 0.75, 1.33


def row(label: str, res: dict) -> dict:
    """One table row from a CLI JSON line."""
    pred, meas = res.get("predicted_run_s"), res["run_s"]
    ratio = pred / meas if pred is not None and meas else None
    return {"run": label, "staged": res.get("staged"),
            "orientation": res.get("orientation"), "batch": res["batch"],
            "bootstraps": res["bootstraps"], "measured_run_s": meas,
            "predicted_run_s": pred, "ratio": ratio,
            "within": ratio is not None and LOW <= ratio <= HIGH}


def table(rows: list[dict]) -> str:
    """A markdown table of the rows."""
    lines = ["| run | staged | kernel | batch | bootstraps | measured s "
             "| predicted s | predicted/measured | within |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        pred = (f"{r['predicted_run_s']:.3f}"
                if r["predicted_run_s"] is not None else "none")
        ratio = f"{r['ratio']:.3f}" if r["ratio"] is not None else "none"
        lines.append(f"| {r['run']} | {r['staged']} | {r['orientation']} "
                     f"| {r['batch']} | {r['bootstraps']} "
                     f"| {r['measured_run_s']:.3f} | {pred} | {ratio} "
                     f"| {r['within']} |")
    return "\n".join(lines)


def _run(argv: list) -> dict:
    from ..runtime.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv)}: exit {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rows = []
    if argv:
        for path in argv:
            with open(path) as f:
                for i, line in enumerate(f):
                    if line.startswith("{") and '"run_s"' in line:
                        rows.append(row(f"{path}:{i + 1}", json.loads(line)))
    else:
        import torch
        if not torch.cuda.is_available():
            print("validate: no CUDA device; the runs are measured on the "
                  "card (or pass files of CLI JSON lines)", file=sys.stderr)
            return 2
        rows = [row(label, _run(args)) for label, args in RUNS]
    print(table(rows))
    within = sum(r["within"] for r in rows)
    print(f"# {within}/{len(rows)} within [{LOW}, {HIGH}]", file=sys.stderr)
    print(json.dumps({"rows": rows, "within": within}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
