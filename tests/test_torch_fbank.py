"""The port's front end (log_mel + cmvn twins) against the JAX batched_fbank.

The CUDA kernels themselves are held against these twins on the card by
chip_smoke.py (this directory's conftest imports jax, which the card's
machine lacks).
"""

import dataclasses

import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio import fbank as jf
from asr_dfcnn_transformer_torch.audio import fbank as tf
from asr_dfcnn_transformer_torch.kernels import cmvn, log_mel
from tests._torch_cpu import use_two_threads

use_two_threads()


@pytest.fixture(scope="module")
def signals():
    """The signals of test_pallas_fbank.py plus one of <= 400 samples."""
    rng = np.random.default_rng(7)
    t = np.arange(40000) / 16000.0
    a = (0.4 * np.sin(2 * np.pi * 523 * t)
         + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    b = np.zeros_like(a)
    b[:25000] = (0.3 * np.sin(2 * np.pi * 907 * t[:25000])
                 + 0.05 * rng.standard_normal(25000)).astype(np.float32)
    c = np.zeros_like(a)
    c[:300] = 0.2 * rng.standard_normal(300).astype(np.float32)
    return np.stack([a, b, c]), np.array([40000, 25000, 300], np.int32)


def _empty_filters():
    return np.flatnonzero(tf.mel_filterbank().sum(axis=0) == 0)


def test_tables_match_jax():
    np.testing.assert_array_equal(tf.mel_filterbank(), jf.mel_filterbank())
    for a, b in zip(tf._dft_bases_np(400, 512), jf._dft_bases_np(400, 512)):
        np.testing.assert_array_equal(a, b)
    for s in (1, 399, 400, 401, 560, 561, 40000):
        assert tf.num_frames(s) == jf.num_frames(s)
    assert len(_empty_filters()) > 0     # the case the CMVN must zero


def _fbank_f64(sigs, lens, out_frames):
    """Exact reference: batched_fbank in float64 numpy from the same f32
    pre-emphasised samples and f32 bases that both packages use."""
    cos_b, sin_b = (b.astype(np.float64) for b in tf._dft_bases_np(400, 512))
    mel = tf.mel_filterbank().astype(np.float64)
    out = np.zeros((len(sigs), out_frames, 200))
    for i, (x, n_s) in enumerate(zip(sigs, lens)):
        pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
        pe = np.where(np.arange(len(x)) < n_s, pe, 0).astype(np.float64)
        n = tf.num_frames(len(x))
        pe = np.pad(pe, (0, (n - 1) * 160 + 400 - len(x)))
        frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)])
        power = ((frames @ cos_b) ** 2 + (frames @ sin_b) ** 2) / 512
        feat = np.log(np.maximum(power @ mel, np.finfo(np.float64).eps))
        v = tf.num_frames(int(n_s))
        mean = feat[:v].mean(0)
        std = feat[:v].std(0)
        std[std == 0] = 1.0
        norm = (feat - mean) / std
        norm = (norm - norm[:v].mean(0)) * (np.arange(n) < v)[:, None]
        m = min(n, out_frames)
        out[i, :m] = norm[:m]
    return out


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("out_frames", [100, 130, 256])
def test_batched_fbank_matches_jax(signals, backend, out_frames):
    """The port against the JAX path at rtol/atol 2e-4 wherever the JAX
    path's f32 DFT is itself within that of the exact value. A bin whose
    power is tiny next to its frame's energy (the DC-only low filters after
    pre-emphasis) cancels in f32, so f32 summation orders disagree there
    by ~1e-3; the port sums the DFT in f64 and must hold the exact value
    everywhere."""
    sigs, lens = signals
    cfg = dataclasses.replace(jf.FbankConfig(), backend=backend)
    want, want_valid = jf.batched_fbank(sigs, lens, cfg=cfg,
                                        out_frames=out_frames)
    want = np.asarray(want)
    got, got_valid = tf.batched_fbank(torch.from_numpy(sigs),
                                      torch.from_numpy(lens),
                                      out_frames=out_frames)
    assert got.shape == (3, out_frames, 200) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    exact = _fbank_f64(sigs, lens, out_frames)
    np.testing.assert_allclose(got, exact, rtol=2e-4, atol=2e-4)
    jax_ok = np.isclose(want, exact, rtol=2e-4, atol=2e-4)
    assert jax_ok.mean() > 0.999
    np.testing.assert_allclose(got[jax_ok], want[jax_ok], rtol=2e-4,
                               atol=2e-4)
    # empty mel filters: a constant log(eps) column normalises to exactly 0
    assert np.all(got[:, :, _empty_filters()] == 0.0)


def test_log_mel_twin_matches_exact(signals):
    """Un-normalised log-mel against float64 numpy and the JAX logfbank."""
    sigs, lens = signals
    n = jf.num_frames(int(lens[1]))
    x = sigs[1, :lens[1]]
    pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
    pe = np.pad(pe.astype(np.float64), (0, (n - 1) * 160 + 400 - len(x)))
    frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)])
    spec = np.abs(np.fft.rfft(frames, 512)) ** 2 / 512
    exact = np.log(np.maximum(spec @ tf.mel_filterbank().astype(np.float64),
                              np.finfo(np.float64).eps))
    got = log_mel(torch.from_numpy(sigs[1:2]), torch.from_numpy(lens[1:2]),
                  n)[0].numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    want = np.asarray(jf.logfbank(x))
    ok = np.isclose(want, exact, rtol=1e-4, atol=1e-3)
    assert ok.mean() > 0.999
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-3)


def test_cmvn_twin_matches_jax_cmvn():
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((3, 40, 16)).astype(np.float32)
    feat[:, :, 5] = -36.04365                 # a constant column
    valid = np.array([40, 17, 0], np.int32)
    got = cmvn(torch.from_numpy(feat), torch.from_numpy(valid)).numpy()
    for i in range(3):
        want = np.asarray(jf.cmvn(feat[i], np.int32(valid[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :, 5] == 0.0)
    assert np.all(got[1, 17:] == 0.0) and np.all(got[2] == 0.0)


def test_wrappers_reject_bad_inputs():
    sig = torch.zeros((2, 800))
    lens = torch.tensor([800, 400], dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        log_mel(sig.double(), lens, 4)
    with pytest.raises(ValueError, match="int32"):
        log_mel(sig, lens.long(), 4)
    with pytest.raises(ValueError, match="fixed"):
        log_mel(sig, lens, 4, cfg=tf.FbankConfig(hop=80))
    with pytest.raises(ValueError, match="int32"):
        cmvn(torch.zeros((2, 4, 8)), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        log_mel(sig.to("meta"), lens.to("meta"), 4)
