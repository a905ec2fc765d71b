"""The benchmark's specification and the files found by its names.

``BENCHMARK.json`` (at the checkout's root) names each cell's configuration
and traffic mix; this module finds ``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<cell>.json`` and, for each per-layer
metric, ``metrics/<metric>.py`` under the benchmark's folder.  Adding a
configuration, a mix, a cell or a metric is adding files and entries: no
code here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported=None) -> bool:
    listed = metric.get("workloads")
    if listed is not None:
        return cell in listed
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the specification at ``root``, with its
    configuration, traffic mix and limits read from ``bench_dir``."""
    spec = load_spec(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       + ", ".join(w["name"] for w in spec["workloads"]))
    work = found[0]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == work["config"])
    config = _json(root / cfg_entry["file"])
    config["name"] = cfg_entry["name"]
    traffic = _json(bench_dir / "traffic" / f"{work['traffic']}.json")
    traffic["name"] = work["traffic"]
    limits = _json(bench_dir / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, chips=int(work["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=layer)


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "lp_bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
