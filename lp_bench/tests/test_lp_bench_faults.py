"""A whole run on the CPU (the harness's look for a card skipped), with the
timed path broken underneath, comes out not correct: for each fault a cell
can have (``faults.py``).  A step that returns its state unchanged;
iterations counted but not run inside the window; half of a batch left
out; an answer altered where the port produces it; a solve to tolerance
that stops early.  (No cell spans chips, so none can lose an exchange
between them.)"""

import pytest

from lp_bench.lib import spec
from lp_bench.tests.faults import FAULTS, KIND_FAULTS
from lp_bench.tests.helpers import run_cpu, tiny_cell

CELLS = {w["name"]: spec.load_cell(w["name"]).traffic["kind"]
         for w in spec.load_spec()["workloads"]}
CASES = [(cell, fault) for cell, kind in CELLS.items()
         for fault in KIND_FAULTS[kind]]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch.setattr)
    result = run_cpu(cell, seconds=1.0)
    assert not result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
