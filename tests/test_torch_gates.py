"""The port's synthetic-corpus accuracy gates on the CPU
(``asr_dfcnn_transformer_torch/gates.py``): the JAX package's
``test_synthetic_{cer,fast,e2e}_gate.py`` with their corpus, seeds, widths,
steps, learning rates and thresholds, and the beam gate on the cer gate's
weights; and ``test_synthetic_{atten,joint,bigru}_gate.py``. Every gate
test is marked slow: the cer, fast and e2e gates take about 1.5, 1 and 2
minutes of CPU each. The check that each gate trains under
PyTorch's deterministic algorithms is not slow.

    python -m pytest tests/test_torch_gates.py -m slow
"""

import pytest
import torch

from asr_dfcnn_transformer_torch import gates
from tests._torch_cpu import use_two_threads

use_two_threads()


@pytest.mark.slow
def test_full_pipeline_accuracy_gate(tmp_path):
    """SE-DFCNN 12/12/24/24/24 (500 steps) + LM d 64 (240 steps): pinyin
    and hanzi accuracy > 0.97 on the 96 unseen utterances; then the beam
    gate: the beam decode (W 8) of the same weights within 0.01 of the
    greedy accuracies, or above them."""
    out = gates.am_lm_gate(str(tmp_path), "cpu", beam=True)
    print(out)
    assert out["utterances"] == out["beam_utterances"] == 96
    assert out["pinyin"] > 0.97, out
    assert out["hanzi"] > 0.97, out
    assert out["beam_pinyin"] >= out["pinyin"] - 0.01, out
    assert out["beam_hanzi"] >= out["hanzi"] - 0.01, out
    assert gates.am_lm_misses(out) == []


@pytest.mark.slow
def test_fast_am_pipeline_accuracy_gate(tmp_path):
    """The same with the space-to-depth AM (``se_dfcnn_fast``)."""
    out = gates.am_lm_gate(str(tmp_path), "cpu", fast=True)
    print(out)
    assert out["utterances"] == 96
    assert out["pinyin"] > 0.97, out
    assert out["hanzi"] > 0.97, out


@pytest.mark.slow
def test_e2e_transformer_accuracy_gate(tmp_path):
    """SpeechTransformer d 64, 2 + 2 blocks (900 steps): the last step's
    teacher-forced accuracy > 0.95, and the cached greedy decode's hanzi
    accuracy > 0.85 over at least 100 unseen utterances."""
    out = gates.e2e_gate(str(tmp_path), "cpu")
    print(out)
    assert out["teacher_forced"] > 0.95, out
    assert out["utterances"] >= 100
    assert out["hanzi"] > 0.85, out
    assert gates.e2e_misses(out) == []


@pytest.mark.slow
def test_ctc_attention_accuracy_gate(tmp_path):
    """CTCAttention d 64, 2 blocks, ceil(T/4) lengths (400 steps): held-out
    hanzi accuracy (1 - LER) > 0.8."""
    out = gates.atten_gate(str(tmp_path), "cpu")
    print(out)
    assert out["accuracy"] > 0.8, out
    assert gates.scored_misses("atten", out) == []


@pytest.mark.slow
def test_joint_am_lm_accuracy_gate(tmp_path):
    """The small AMLMJoint (450 steps): held-out lm_acc through the AM's
    own greedy decode > 0.92."""
    out = gates.joint_gate(str(tmp_path), "cpu")
    print(out)
    assert out["lm_acc"] > 0.92, out
    assert gates.scored_misses("joint", out) == []


@pytest.mark.slow
def test_bigru_accuracy_gate(tmp_path):
    """BiGRUCTC hidden 48, one layer (700 steps, 64-frame buckets):
    held-out pinyin accuracy (1 - LER) > 0.65."""
    out = gates.bigru_gate(str(tmp_path), "cpu")
    print(out)
    assert out["accuracy"] > 0.65, out
    assert gates.scored_misses("bigru", out) == []


@pytest.mark.slow
def test_gate_thresholds_are_the_jax_gates():
    """The thresholds phase 15 of chip_smoke.py reads are the JAX gates'."""
    assert (gates.AM_LM_MIN_ACCURACY, gates.E2E_MIN_TEACHER_FORCED,
            gates.E2E_MIN_ACCURACY, gates.E2E_MIN_UTTERANCES,
            gates.BEAM_SLACK) == (0.97, 0.95, 0.85, 100, 0.01)
    assert (gates.ATTEN_MIN_ACCURACY, gates.JOINT_MIN_LM_ACC,
            gates.BIGRU_MIN_ACCURACY) == (0.8, 0.92, 0.65)


@pytest.mark.slow
def test_misses_name_each_failed_condition():
    good = {"utterances": 96, "pinyin": 0.99, "hanzi": 0.98,
            "beam_pinyin": 0.985, "beam_hanzi": 0.99}
    assert gates.am_lm_misses(good) == []
    bad = dict(good, hanzi=0.97, beam_pinyin=0.979, utterances=95)
    assert len(gates.am_lm_misses(bad)) == 3
    e2e = {"teacher_forced": 0.96, "hanzi": 0.9, "utterances": 144}
    assert gates.e2e_misses(e2e) == []
    assert len(gates.e2e_misses(dict(e2e, teacher_forced=0.95,
                                      hanzi=0.85, utterances=99))) == 3


@pytest.mark.parametrize("gate", gates.GATES)
def test_gates_train_under_deterministic_algorithms(gate, monkeypatch):
    """Each gate runs under ``torch.use_deterministic_algorithms`` (on the
    card cuDNN's default convolution backward and ``scatter_add_`` do not
    repeat from run to run) and restores the setting afterwards, also when
    the gate raises."""
    seen = []

    def corpus(*args):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled()))
        raise RuntimeError("stop")

    monkeypatch.setattr(gates, "corpus", corpus)
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    with pytest.raises(RuntimeError, match="stop"):
        gates.run(gate, "cpu")
    assert seen == [(True, True)]
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled()) == before
