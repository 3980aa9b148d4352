"""The committed cells on the card at their own sizes: a short run of each
is correct and its control is not (gpu marker; run on a machine with the
card: python -m pytest -m gpu fhebench/tests)."""

import pytest

from _tiny import REPO  # noqa: F401  (puts the repository on the path)
from fhebench.harness import spec

CELLS = ("laplace.single", "hamming.batch64")


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
