"""A short run of a small cell on the card (the grouped leaf kernel, #1,
built and launched): run with ``python -m pytest -m cuda
portbench/tests``."""

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests.tiny import tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_small_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell()
    result, verdict = run_cell(cell, 11, 0.5, trace, torch.device("cuda", 0),
                               0.0)
    assert verdict.correct, verdict.numbers
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert result["metrics"]["leaf_roofline"]["value"] > 0
        assert result["device"]["busy_s"] > 0
    else:
        assert result["metrics"]["index_bytes"]["value"] > 0
