"""A run with its timed path broken underneath comes out not correct: the
tiny cells on the CPU, held to their real cells' limits, with each fault a
cell can have planted in the program (one chip: no exchange between chips
to leave out). The unbroken tiny cells come out correct."""

import numpy as np
import pytest
import torch

from helpers import TINY, run_cpu, tiny_root

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", sorted(TINY))
def test_unbroken_cells_are_correct(root, cell):
    out, _ = run_cpu(root, cell)
    assert out["correct"], out["checks"]


def _alter_token(monkeypatch, where="hanzi"):
    from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
    plain = Pipeline.recognize_batch

    def altered(self, *a, **k):
        pny, plen, han = plain(self, *a, **k)
        pny, han = pny.copy(), han.copy()
        for i in range(len(plen)):
            if plen[i]:
                if where == "hanzi":
                    han[i, 0] = (han[i, 0] + 1) % 6345
                else:
                    pny[i, 0] = (pny[i, 0] + 1) % 1535
        return pny, plen, han

    monkeypatch.setattr(Pipeline, "recognize_batch", altered)


@pytest.mark.parametrize("cell", ["tiny_keras_offline", "tiny_se_offline"])
@pytest.mark.parametrize("where", ["hanzi", "pinyin"])
def test_a_token_altered_where_it_is_produced(root, monkeypatch, cell,
                                              where):
    _alter_token(monkeypatch, where)
    out, _ = run_cpu(root, cell)
    assert not out["correct"]


def test_half_the_batch_left_out_offline(root, monkeypatch):
    from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
    plain = Pipeline.recognize_batch

    def half(self, signals, lengths, *a, **k):
        n = len(lengths) // 2
        return plain(self, signals[:n], lengths[:n], *a, **k)

    monkeypatch.setattr(Pipeline, "recognize_batch", half)
    out, _ = run_cpu(root, "tiny_se_offline")
    assert not out["correct"]


def _freeze_after(monkeypatch, steps: int):
    """``apply_gradients`` counts the step and leaves the state as it is,
    from step ``steps + 1`` on."""
    from asr_dfcnn_transformer_torch.train import trainer
    plain = trainer._TrainerBase.apply_gradients

    def frozen(self):
        if self.step < steps:
            return plain(self)
        self.step += 1
        return self.schedule(self.step - 1)

    monkeypatch.setattr(trainer._TrainerBase, "apply_gradients", frozen)


def test_a_step_that_leaves_the_state_unchanged(root, monkeypatch):
    _freeze_after(monkeypatch, 0)
    out, _ = run_cpu(root, "tiny_se_train")
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] > 0.9


def test_a_window_that_leaves_the_state_unchanged(root, monkeypatch):
    # the three checked steps are sound; every step after them is not
    _freeze_after(monkeypatch, 3)
    out, rec = run_cpu(root, "tiny_se_train")
    assert rec["steps"] > 0 and not out["correct"]
    assert out["checks"]["update_gap"]["value"] < 0.2
    assert out["checks"]["window_unmoved"]["value"] > 0
    assert out["checks"]["next_update_gap"]["value"] > 0.9


def test_a_window_that_trains_on_stale_inputs(root, monkeypatch):
    # from step 4 on, every step runs the batch of step 3 again; the batch
    # the rotation has due after the window may be that one, the fresh
    # batch never is
    from asr_dfcnn_transformer_torch.train import trainer
    plain = trainer.AMTrainer.train_step
    seen = []

    def stale(self, batch, generator=None):
        seen.append(batch)
        return plain(self, seen[min(len(seen), 3) - 1], generator)

    monkeypatch.setattr(trainer.AMTrainer, "train_step", stale)
    out, rec = run_cpu(root, "tiny_se_train")
    assert rec["steps"] > 0 and not out["correct"]
    fresh = out["checks"]["fresh_loss_gap"]
    assert fresh["value"] > fresh["limit"]


def test_a_window_loss_that_is_not_finite(root, monkeypatch):
    from asr_dfcnn_transformer_torch.train import trainer
    plain = trainer.AMTrainer.train_step

    def nan_after_three(self, batch, generator=None):
        out = plain(self, batch, generator)
        if self.step > 3:
            out["loss"] = out["loss"] * float("nan")
        return out

    monkeypatch.setattr(trainer.AMTrainer, "train_step", nan_after_three)
    out, _ = run_cpu(root, "tiny_se_train")
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["failed"]["value"] > 0


def test_half_the_batch_left_out_in_training(root, monkeypatch):
    from portbench import system
    plain = system.am_batch

    def half(b):
        out = plain(b)
        w = np.ones_like(out.weights)
        w[len(w) // 2:] = 0.0
        out.weights = w
        return out

    monkeypatch.setattr(system, "am_batch", half)
    out, _ = run_cpu(root, "tiny_se_train")
    assert not out["correct"]
    nxt = out["checks"]["next_loss_gap"]
    assert nxt["value"] > nxt["limit"]
