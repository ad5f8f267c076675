"""The control comes out not correct: the reference computed in fp8 (the
precision below the configurations' bf16), put in the program's place and
read as the program is, fails one of its cell's numbers. Here at the tiny
sizes on the CPU, held to the real cells' limits; ``calibrate.py`` reads
it at the cells' own sizes on the chip."""

import pytest
import torch

from helpers import TINY, run_cpu, tiny_root
from portbench import compare

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(root, cell):
    out, rec = run_cpu(root, cell)
    assert out["correct"]
    limits = compare.limits_for(root, cell)
    control = rec["control"]()
    ok, checks = compare.judge(control, limits)
    assert not ok, checks
