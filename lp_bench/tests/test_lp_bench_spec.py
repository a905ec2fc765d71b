"""BENCHMARK.json against the contract, and every cell, configuration,
traffic mix and metric found by its name, also ones added as files."""

import json
import re
import shutil

import pytest

from lp_bench.lib import spec
from lp_bench.tests.helpers import run_cpu, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["lp_bench"]
    assert SPEC["command"][1] == "lp_bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_bounds():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_cell_reports_what_it_must():
    for name in CELLS:
        cell = spec.load_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.traffic["kind"] in ("single_solve", "closed_loop", "batch")
    assert cell.config["reduced"] == []
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_limits_name_every_number_the_check_gives(name):
    """Each cell's limits file holds a limit for every number its kind of
    check compares (and its readings); a solve to tolerance is held to
    the ``stop_tol`` its mix states."""
    cell = spec.load_cell(name)
    kind = cell.traffic["kind"]
    numbers = {"single_solve": {"start_energy", "start_viol",
                                "window_energy", "window_viol", "final_gap"},
               "batch": {"start_energy", "start_viol", "window_energy",
                         "window_viol", "final_gap"},
               "closed_loop": {"stop_viol", "stop_gap", "resid",
                               "energy_gap"}}[kind]
    assert set(cell.limits) == numbers | {"readings"}
    assert set(cell.limits["readings"]) - {"note"} == numbers | {"source"}
    if kind == "closed_loop":
        tol = cell.traffic["solve_kwargs"]["stop_tol"]
        assert cell.limits["stop_viol"] == cell.limits["stop_gap"] == tol
        assert tol < cell.limits["resid"] < 1.1 * tol
    else:
        assert cell.traffic["check_checkpoints"] >= 3


def test_check_budget_fits_24_cells():
    runs = 2 + 14 * 24
    need = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert need <= 43200


def test_added_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files (and entries in BENCHMARK.json) are found and
    run by the unchanged harness."""
    bench = tmp_path / "lp_bench"
    shutil.copytree(spec.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "potts_binary_300.json").read_text())
    cfg["image_size"] = 10
    (bench / "configs" / "potts_binary_10.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "steady_ck300.json").write_text(json.dumps(
        {"kind": "single_solve", "why": "test", "nb_iter_plot": 300,
         "check_checkpoints": 3}))
    (bench / "limits" / "potts10.steady.json").write_text(json.dumps(
        {"start_energy": 1e-4, "start_viol": 1e-4, "window_energy": 1e-4,
         "window_viol": 1e-4, "final_gap": 1e-3}))
    (bench / "metrics" / "chunks_in_window.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run.chunks()))\n")
    data["configs"].append({"name": "potts_binary_10", "source": "test",
                            "file": "lp_bench/configs/potts_binary_10.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "potts10.steady",
                              "config": "potts_binary_10",
                              "traffic": "steady_ck300", "chips": 1,
                              "why": "test"})
    data["end_to_end"][0]["workloads"].append("potts10.steady")
    data["per_layer"].append({"name": "chunks_in_window", "unit": "chunks",
                              "better": "higher", "source": "program_span",
                              "layer": "chunk loop and restart controller",
                              "moves": "iters_per_s",
                              "workloads": ["potts10.steady"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    cell = spec.load_cell("potts10.steady", root=tmp_path, bench_dir=bench)
    assert cell.config["image_size"] == 10
    assert cell.traffic["nb_iter_plot"] == 300
    assert [m["name"] for m in cell.per_layer] == ["chunks_in_window"]
    reader = spec.metric_reader("chunks_in_window", bench)
    result = run_cpu(cell, seconds=1.0)
    assert result["correct"] and "iters_per_s" in result["metrics"]
    assert result["detail"]["iterations"] % 300 == 0

    class Ctx:
        run = type("R", (), {"chunks": lambda self: [300, 300]})()

    assert reader(Ctx()) == 2.0


def test_tiny_cells_run_correct_on_the_cpu():
    for name in CELLS:
        result = run_cpu(tiny_cell(name), seconds=1.0)
        assert result["correct"], (name, result["checks"])
        assert list(result)[-1] == "checks"
