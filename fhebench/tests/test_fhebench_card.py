"""The committed cells on the card at their own sizes: a short run of each
is correct and its control is not; nor is the CKKS cell that the tests
keep (_tiny.py) at a scale 2^10 lower (gpu marker; run on a machine with
the card: python -m pytest -m gpu fhebench/tests)."""

import json
import os

import pytest

from _tiny import REPO, full_cell
from fhebench.harness import spec

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    from fhebench.run import run_cell
    cell = spec.load_cell(name)
    result, table = run_cell(cell, 2 ** 31 + 21, 2.0, False, card)
    assert result["correct"], table
    assert result["device"]["platform"] == "gpu"
    result, table = run_cell(cell, 2 ** 31 + 21, 1.0, False, card,
                             control=True)
    assert not result["correct"], table


@pytest.mark.gpu
def test_ckks_program_at_a_lower_scale_on_the_card(card, tmp_path):
    from fhebench.run import run_cell
    cell = full_cell(tmp_path, "logreg.single")
    cell.config = dict(cell.config, scale_bits=cell.config["scale_bits"] - 10)
    result, table = run_cell(cell, 2 ** 31 + 23, 1.0, False, card)
    assert not result["correct"], table
    assert result["run"]["max_abs_error"] > 10 * cell.config["tolerance"]
