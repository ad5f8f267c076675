"""On the card: each cell of ``BENCHMARK.json`` runs once, briefly, traced
and not, and comes out correct with its metrics.

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from helpers import PB
from portbench import manifest

CELLS = [w["name"] for w in manifest.load(PB.parent / "BENCHMARK.json")[
    "workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 3 + trace),
                        "--seconds", "3", "--trace", str(trace)],
                       cwd=PB.parent, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], r.stderr[-2000:]
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    if trace:
        assert out["device"]["busy_s"] > 0
