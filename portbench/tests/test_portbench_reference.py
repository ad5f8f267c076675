"""The plain reference agrees with the port's CPU twins at small widths, in
float32 (the port's models at ``dtype=float32``, their kernels' twins)."""

import numpy as np
import pytest
import torch

from helpers import DATA
from portbench import manifest, system, traffic, weights
from portbench.compare import dropout_keep
from portbench.reference import ctc as rctc
from portbench.reference import fbank as rfbank
from portbench.reference import models as rm
from portbench.reference.precision import F32

torch.set_num_threads(2)
SE = manifest.load(DATA / "configs" / "tiny_se.json")
KERAS = manifest.load(DATA / "configs" / "tiny_keras.json")
SEED = 2 ** 32 + 77


def _signals(bucket=400, n=3):
    lens = np.array([9000, 30000, traffic.samples_for_frames(bucket) - 5])
    v = manifest.load(DATA / "traffic" / "tiny_offline.json")["voicing"]
    cls = traffic.syllables(np.random.default_rng(0), lens, v)
    sig = traffic.voice(lens, cls, traffic.samples_for_frames(bucket), v, 1,
                        "cpu")
    return torch.as_tensor(sig[:n]), torch.as_tensor(lens[:n])


def test_fbank_matches_the_port():
    from asr_dfcnn_transformer_torch.audio.fbank import batched_fbank
    sig, lens = _signals()
    port, _ = batched_fbank(sig, lens.to(torch.int32), out_frames=400)
    ref = rfbank.fbank(sig, lens, 400)
    assert ref.shape == port.shape
    assert torch.allclose(ref, port, atol=2e-4, rtol=1e-4)


def test_logit_lengths_match_the_port():
    from asr_dfcnn_transformer_torch.models.dfcnn import (frames_from_samples,
                                                          logit_lengths)
    n = torch.tensor([1, 400, 401, 16000, 256240])
    assert torch.equal(rfbank.logit_lengths(n, 200).int(),
                       logit_lengths(frames_from_samples(n), 200))


@pytest.mark.parametrize("cfg", [SE, KERAS], ids=["se", "keras"])
def test_acoustic_models_match_the_port(cfg):
    model = system.build_am(cfg, SEED, "cpu").eval()
    w = weights.for_model(cfg, "am", SEED, "cpu")
    x = torch.randn(2, 1, 64, 200, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = model(x)
        ref = rm.acoustic_model(cfg["am"]["family"])(w, cfg["am"], x, F32)
    assert torch.allclose(ref, port, atol=1e-4, rtol=1e-4)


def test_se_training_forward_matches_the_port():
    model = system.build_am(SE, SEED, "cpu").train()
    w = weights.for_model(SE, "am", SEED, "cpu")
    x = torch.randn(2, 1, 64, 200, generator=torch.Generator().manual_seed(4))
    port = model(x, generator=torch.Generator().manual_seed(9))
    keep = dropout_keep(SE, 2, 64, 9, "cpu")
    ref = rm.se_dfcnn(w, SE["am"], x, F32, train=True, keep=keep)
    assert torch.allclose(ref, port.detach(), atol=1e-4, rtol=1e-4)


def test_lm_matches_the_port():
    model = system.build_lm(SE, SEED, "cpu").eval()
    w = weights.for_model(SE, "lm", SEED, "cpu")
    ids = torch.randint(1, 1536, (3, 100), generator=torch.Generator()
                        .manual_seed(5))
    ids[0, 40:] = 0
    ids[1, 0] = 0                    # a fully masked first row
    with torch.no_grad():
        port = model(ids)
        ref = rm.lm(w, SE["lm"], ids, F32)
    assert torch.allclose(ref, port, atol=1e-4, rtol=1e-4)


def test_ctc_loss_matches_the_port():
    from asr_dfcnn_transformer_torch.ops.ctc import ctc_loss
    g = torch.Generator().manual_seed(6)
    logits = torch.randn(3, 50, 40, generator=g)
    lens = torch.tensor([50, 31, 12])
    labels = torch.randint(1, 39, (3, 10), generator=g)
    lab_len = torch.tensor([10, 7, 3])
    port = ctc_loss(logits, lens, labels, lab_len, blank_id=-1)
    ref = rctc.ctc_losses(logits, lens, labels, lab_len)
    assert torch.allclose(ref, port, rtol=1e-5)


def test_greedy_matches_the_port():
    from asr_dfcnn_transformer_torch.ops.ctc_decode import ctc_greedy_decode
    g = torch.Generator().manual_seed(7)
    logits = torch.randn(4, 60, 12, generator=g)
    logits[..., -1] += 1.0
    lens = torch.tensor([60, 33, 5, 1])
    ids, n = ctc_greedy_decode(logits, lens, blank_id=-1, max_output_len=8)
    ref = rctc.greedy(logits, lens, 8)
    assert [ids[i, :n[i]].tolist() for i in range(4)] == ref
