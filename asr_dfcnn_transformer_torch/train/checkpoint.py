"""Checkpoints with a metric-gated "best" copy and resume-from-latest: the
port of ``train/checkpoint.py``'s ``CheckpointManager``, on ``torch.save``.

Layout under ``directory``: ``<step>.pt`` for each kept step (the newest
``max_to_keep``), ``best/state.pt`` and ``best/metric.json``. A state is
whatever dict the trainer hands in (its model, its optimizer and its step);
every file is written to a temporary name first and renamed into place, so
a crash never leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional

import torch


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._best_dir = os.path.join(self.directory, "best")
        os.makedirs(self._best_dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def steps(self) -> List[int]:
        """The kept steps, oldest first."""
        out = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if ext == ".pt" and stem.isdigit():
                out.append(int(stem))
        return sorted(out)

    def save(self, step: int, state: Any) -> None:
        _atomic_save(state, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def save_best(self, state: Any, metric: Optional[float] = None) -> None:
        """Overwrite the best checkpoint; ``metric`` is persisted beside it
        (after the state) so a resumed run's gate starts from the
        historical best."""
        _atomic_save(state, os.path.join(self._best_dir, "state.pt"))
        if metric is not None:
            path = os.path.join(self._best_dir, "metric.json")
            with open(f"{path}.tmp", "w") as f:
                json.dump({"metric": float(metric)}, f)
            os.replace(f"{path}.tmp", path)

    def best_metric(self) -> Optional[float]:
        """The persisted gating metric of the best checkpoint, or None."""
        path = os.path.join(self._best_dir, "metric.json")
        if self._best_path() is None or not os.path.exists(path):
            return None
        with open(path) as f:
            return float(json.load(f)["metric"])

    def _best_path(self) -> Optional[str]:
        path = os.path.join(self._best_dir, "state.pt")
        return path if os.path.exists(path) else None

    def restore_best(self) -> Optional[Any]:
        path = self._best_path()
        if path is None:
            return None
        return torch.load(path, map_location="cpu", weights_only=True)
