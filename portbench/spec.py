"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells.  A cell's
configuration is ``portbench/configs/<config>.json``, its traffic mix
``portbench/traffic/<traffic>.json`` and the limits of its correctness
comparison ``portbench/limits/<workload>.json``.  The mix names its
``driver``, the code that drives the program and its reference:
``portbench/traffic/<driver>.py``.  A metric, end-to-end or per-layer, is
read by ``portbench/metrics/<name>.py``, or, where no file carries the
whole name, by ``portbench/metrics/<name up to its first dot>.py``.  A
later cell is added as new files and new entries, with no edit.
"""

import importlib
import importlib.util
import json
import re
from types import ModuleType
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _reported_in(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``bench_path`` with its files loaded; a
    name that the file does not hold raises ``KeyError``."""
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported_in(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reported_in(m, workload)],
    )


def traffic_module(driver: str) -> ModuleType:
    """``portbench/traffic/<driver>.py``: its ``Driver`` runs the program,
    its ``Reference`` checks it."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", driver):
        raise ValueError(f"a driver's name is an identifier, not {driver!r}")
    if not (HERE / "traffic" / f"{driver}.py").exists():
        raise FileNotFoundError(f"no driver {driver!r} under {HERE / 'traffic'}")
    return importlib.import_module(f"portbench.traffic.{driver}")


def metric_reader(name: str) -> Callable:
    """The ``read`` function of the metric ``name``'s file."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            mod_name = "portbench.metrics." + stem.replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for the metric {name!r} under "
                            f"{HERE / 'metrics'}")
