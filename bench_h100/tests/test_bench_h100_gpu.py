"""The small cells on the card, traced: every per-layer reader finds
something to read, each share lies in (0, 100], and the run is correct.

    python -m pytest bench_h100/tests/test_bench_h100_gpu.py -q   # on a card
"""

import pytest
import torch

from bench_h100.harness.cell import is_correct, run_cell
from bench_h100.harness.spec import metric_reader

READERS = ["idle_share", "around_share", "kernel_roofline", "eval_roofline",
           "pad_share"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["native", "staged"])
def test_small_cell_traced_on_the_card(tiny, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = run_cell(tiny(kind, noise_limit=0.05), 2 ** 31 + 3, 0.0, True,
                   ["cuda:0"], batches=2)
    assert is_correct(run), run.compared
    assert run.trace.window_s > 0 and run.trace.ops
    for name in READERS:
        value = metric_reader(name)(run)
        assert value is not None and 0 <= value <= 100, (name, value)
    assert metric_reader("kernel_roofline")(run) > 0
