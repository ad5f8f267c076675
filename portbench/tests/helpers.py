"""A throwaway benchmark root for the CPU tests: the real drivers and
readers, the tiny configurations and traffic under ``tests/data``, and a
manifest of tiny cells named after the real cells whose limits they use."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import manifest, run

HERE = Path(__file__).resolve().parent
PB = HERE.parent
DATA = HERE / "data"

TINY = {
    "tiny_keras_offline": ("tiny_keras", "tiny_offline", "keras_lm_offline_b128"),
    "tiny_se_offline": ("tiny_se", "tiny_offline", "se_lm_offline_b128"),
    "tiny_se_train": ("tiny_se", "tiny_train", "se_am_train_b64"),
}


def tiny_root(tmp: Path) -> Path:
    """A root holding links to the real drivers and readers, the tiny
    traffic, each tiny cell's limits copied from its real cell, and a
    manifest whose metrics are the real manifest's, cut to the tiny cells."""
    root = tmp / "root"
    root.mkdir()
    for d in ("drivers", "metrics"):
        (root / d).symlink_to(PB / d)
    shutil.copytree(DATA / "traffic", root / "traffic")
    (root / "limits").mkdir()
    real = manifest.load(PB.parent / "BENCHMARK.json")
    for tiny, (_, _, cell) in TINY.items():
        src = PB / "limits" / f"{cell}.json"
        if src.is_file():
            shutil.copy(src, root / "limits" / f"{tiny}.json")
    def cut(metrics):
        out = []
        for m in metrics:
            m = dict(m)
            if "workloads" in m:
                m["workloads"] = [t for t, (_, _, c) in TINY.items()
                                  if c in m["workloads"]]
            out.append(m)
        return out

    man = {"configs": [{"name": n, "file": str(DATA / "configs" / f"{n}.json")}
                       for n in ("tiny_se", "tiny_keras")],
           "workloads": [{"name": t, "config": c, "traffic": tr, "chips": 1}
                         for t, (c, tr, _) in TINY.items()],
           "end_to_end": cut(real["end_to_end"]),
           "per_layer": cut(real["per_layer"])}
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run_cpu(root: Path, name: str, seed: int = 2 ** 33 + 5,
            seconds: float = 1.0, trace: bool = False):
    cell = manifest.cell(root / "BENCHMARK.json", name, root)
    return run.execute(cell, seed, seconds, trace, "cpu", root,
                       time.perf_counter())
