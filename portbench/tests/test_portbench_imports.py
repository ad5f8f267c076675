"""No module that a benchmark run loads is JAX's, Flax's or the JAX
package's, compared by whole top-level names; the reference loads nothing
of the port either."""

import json
import subprocess
import sys

from helpers import PB

FORBIDDEN = ["jax", "jaxlib", "flax", "asr_dfcnn_transformer_tpu"]

PROBE = r"""
import json, sys
from pathlib import Path
import importlib
for m in {mods!r}:
    importlib.import_module(m)
if {readers!r}:
    from portbench import manifest
    for p in sorted(Path("portbench/metrics").glob("*.py")):
        manifest.reader(p.stem)
    for p in sorted(Path("portbench/drivers").glob("*.py")):
        manifest.driver(p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(mods, readers):
    r = subprocess.run([sys.executable, "-c",
                        PROBE.format(mods=mods, readers=readers)],
                       cwd=PB.parent, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    top = _loaded(["portbench.run", "portbench.harness", "portbench.system",
                   "portbench.compare", "portbench.calibrate",
                   "asr_dfcnn_transformer_torch.infer",
                   "asr_dfcnn_transformer_torch.train.trainer"], True)
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "asr_dfcnn_transformer_torch" in top


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded(["portbench.reference.models", "portbench.reference.ctc",
                   "portbench.reference.fbank",
                   "portbench.reference.precision", "portbench.compare",
                   "portbench.weights", "portbench.traffic",
                   "portbench.work"], False)
    assert not top & set(FORBIDDEN + ["asr_dfcnn_transformer_torch"])


def test_the_run_refuses_a_forbidden_module():
    from portbench import run
    sys.modules.setdefault("jaxlib_probe_", None)
    assert "jaxlib_probe_" not in run.forbidden_modules()
    fake = type(sys)("flax.linen")
    sys.modules["flax.linen"] = fake
    try:
        assert run.forbidden_modules() == ["flax.linen"]
    finally:
        del sys.modules["flax.linen"]
        del sys.modules["jaxlib_probe_"]
