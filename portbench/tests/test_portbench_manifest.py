"""The manifest keeps the contract's rules, names only files that exist,
and a cell added as files alone runs with no code edit."""

import json
import re
import subprocess
import sys

import pytest

from helpers import PB, run_cpu, tiny_root
from portbench import manifest

MANIFEST = PB.parent / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return manifest.load(MANIFEST)


def test_keys_and_names_fit_the_rules(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51
    assert all(LINE.match(w) for w in man["command"])
    names = [c["name"] for c in man["configs"]]
    names += [w["name"] for w in man["workloads"]]
    metrics = man["end_to_end"] + man["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in man["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(json.dumps(man)) < 64 * 1024


def test_bounds(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in man["end_to_end"]} >= {"setup_s"}


def test_every_moves_is_reported_where_its_metric_is(man):
    cells = [w["name"] for w in man["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in man["end_to_end"]}
    layers = {}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m
        for c in m.get("workloads", cells):
            assert c in e2e[m["moves"]], (m["name"], c)
        assert LINE.match(m["layer"])
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for c in cells:
        reported = [n for n, ws in e2e.items() if c in ws]
        assert "setup_s" in reported and len(reported) >= 2, c
        assert any(c in m.get("workloads", cells) for m in man["per_layer"])


def test_every_named_file_exists(man):
    for c in man["configs"]:
        assert (PB.parent / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in man["workloads"]:
        t = manifest.load(PB / "traffic" / f"{w['traffic']}.json")
        assert (PB / "drivers" / f"{t['driver']}.py").is_file()
        assert (PB / "limits" / f"{w['name']}.json").is_file(), w["name"]
    for m in man["end_to_end"] + man["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_a_cell_added_as_files_alone_runs(tmp_path):
    root = tiny_root(tmp_path)
    man = json.loads((root / "BENCHMARK.json").read_text())
    t = json.loads((root / "traffic" / "tiny_offline.json").read_text())
    t["buckets"], t["cycle_batches"] = [800], 1
    (root / "traffic" / "tiny_other.json").write_text(json.dumps(t))
    (root / "limits" / "tiny_new.json").write_text(
        (root / "limits" / "tiny_keras_offline.json").read_text())
    man["workloads"].append({"name": "tiny_new", "config": "tiny_keras",
                             "traffic": "tiny_other", "chips": 1})
    for m in man["end_to_end"] + man["per_layer"]:
        if "tiny_keras_offline" in m.get("workloads", ()):
            m["workloads"].append("tiny_new")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    out, rec = run_cpu(root, "tiny_new")
    assert out["correct"] and out["attempted"] > 0
    assert {"audio_s_per_s", "setup_s"} <= set(out["metrics"])
    assert all(b.bucket == 800 for b in rec["done"])


def test_unknown_workload_exits_nonzero_at_once():
    r = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "no_such_cell", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=PB.parent, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no_such_cell" in r.stderr
