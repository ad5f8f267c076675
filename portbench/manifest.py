"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` is its JSON) and a traffic mix (``portbench/traffic/
<traffic>.json``, whose ``driver`` names ``portbench/drivers/<driver>.py``).
Every metric is read by ``portbench/metrics/<name>.py``; a metric is the
cell's when it lists the cell under ``workloads`` or lists no cells. A
cell's output limits are ``portbench/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parent
#: the manifest, at the root of the checkout a run starts from
MANIFEST = "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    e2e: List[dict]
    per_layer: List[dict]


def load(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _mine(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(manifest_path: Path, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the manifest; KeyError when there is none."""
    m = load(manifest_path)
    w = {c["name"]: c for c in m["workloads"]}.get(name)
    if w is None:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    config = load(Path(manifest_path).parent / conf["file"])
    traffic = load(root / "traffic" / f"{w['traffic']}.json")
    return Cell(name, int(w["chips"]), config, traffic,
                [x for x in m["end_to_end"] if _mine(x, name)],
                [x for x in m["per_layer"] if _mine(x, name)])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    return _module(root / "metrics" / f"{metric}.py",
                   "portbench_metric_" + metric.replace(".", "_")).read


def driver(name: str, root: Path = ROOT):
    """The ``run(ctx)`` function of ``drivers/<name>.py``."""
    return _module(root / "drivers" / f"{name}.py",
                   "portbench_driver_" + name).run
