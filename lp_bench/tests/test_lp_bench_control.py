"""The control (the reference in bfloat16 in the program's place) comes out
not correct in every cell, at a size a test run holds (the program's own
tiny runs come out correct: ``test_lp_bench_spec.py``).  ``control.py``
runs it at each cell's own size on the card."""

import pytest

from lp_bench.lib import spec
from lp_bench.tests.control import control_run
from lp_bench.tests.helpers import SEED, tiny_cell

CELLS = [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name, size=40)
    nums, _, failed = control_run(cell, SEED, "cpu", iterations=4000,
                                  solves=2)
    assert failed > 0 or any(nums[k] > cell.limits[k] for k in nums), nums


@pytest.mark.cuda
def test_control_at_cell_size_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.load_cell("potts500.steady")
    nums, _, failed = control_run(cell, SEED, "cuda", iterations=20000)
    assert failed > 0, nums
