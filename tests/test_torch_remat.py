"""``SEDFCNNConfig(remat_stages=N)``: the port of the JAX model's
``nn.remat`` of its first N stages (tests/test_model_variants.py), on
``torch.utils.checkpoint``. It changes no parameter name and no value: the
evaluation forward is bit-equal, the gradients equal within float
reassociation, and the recompute in the backward leaves the BatchNorms'
running statistics as one forward left them."""

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
from asr_dfcnn_transformer_torch.train import AMTrainer
from tests._torch_cpu import use_two_threads

use_two_threads()

KW = dict(stage_features=(4, 4, 8, 8, 8), se_ratio=(1, 2, 2, 2, 2),
          head_features=8, dropout_rate=0.0, dtype=torch.float32)


def _am_arrays(b=3, bucket=64):
    rng = np.random.default_rng(1)
    n = (bucket - 1) * 160 + 400
    lens = np.array([n, 7000, 5000][:b], np.int32)
    sig = (0.3 * rng.standard_normal((b, n))).astype(np.float32)
    sig[np.arange(n)[None, :] >= lens[:, None]] = 0
    pinyin = np.zeros((b, 4), np.int32)
    pinyin[:, :2] = rng.integers(1, 31, (b, 2))
    return dict(signals=sig, signal_lengths=lens,
                frame_lengths=(1 + (lens - 400) // 160).astype(np.int32),
                pinyin=pinyin, pinyin_lengths=np.full(b, 2, np.int32),
                hanzi=pinyin.copy(), hanzi_lengths=np.full(b, 2, np.int32),
                weights=np.ones(b, np.float32), bucket_frames=bucket)


def _pair(se_first=False):
    m0 = SEDFCNN(SEDFCNNConfig(32, se_first=se_first, **KW), feature_dim=40,
                 device="cpu", generator=torch.Generator().manual_seed(0))
    m1 = SEDFCNN(SEDFCNNConfig(32, se_first=se_first, remat_stages=2, **KW),
                 feature_dim=40, device="cpu",
                 generator=torch.Generator().manual_seed(5))
    assert list(m0.state_dict()) == list(m1.state_dict())  # no renames
    m1.load_state_dict(m0.state_dict())
    return m0, m1


@pytest.mark.parametrize("se_first", [False, True])
def test_sedfcnn_remat_stages_weight_parity_and_math(se_first):
    m0, m1 = _pair(se_first)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, 32, 40)).astype(np.float32))
    m0.eval(), m1.eval()
    assert torch.equal(m0(x), m1(x))
    m0.train(), m1.train()
    (m0(x) ** 2).sum().backward()
    (m1(x) ** 2).sum().backward()
    for (name, a), b in zip(m0.named_parameters(), m1.parameters()):
        np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # one training forward's update of the running statistics, not two
    for (name, a), b in zip(m0.named_buffers(), m1.buffers()):
        assert torch.equal(a, b), name


def test_remat_train_step_equals_plain_step(tmp_path):
    """An ``AMTrainer`` step: the same loss, parameters within float
    reassociation and the running statistics bit for bit."""
    arrays = _am_arrays()
    out = []
    for m, name in zip(_pair(), ("plain", "remat")):
        tr = AMTrainer(m, str(tmp_path / name), feature_dim=40)
        out.append((float(tr.train_step(AMBatch(**arrays))["loss"]),
                    m.state_dict()))
    (l0, sd0), (l1, sd1) = out
    assert l0 == l1
    for name, a in sd0.items():
        if "running" in name:
            assert torch.equal(a, sd1[name]), name
        else:
            np.testing.assert_allclose(sd1[name].numpy(), a.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
