"""The port's single-utterance front end (``audio/fbank.py``: ``logfbank``,
``cmvn``, ``compute_fbank_from_signal``, ``log_spectrogram``,
``log_spectrogram_asrt``) against the JAX package's, signals shorter than
one window included, and the exports of ``audio/__init__.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import audio as jax_audio
from asr_dfcnn_transformer_tpu.audio import fbank as jf
from asr_dfcnn_transformer_torch import audio
from asr_dfcnn_transformer_torch.audio import fbank as tf
from tests._torch_cpu import use_two_threads

use_two_threads()

# sample counts: below one window, one window, one sample past it, one
# second, and a ragged length
LENGTHS = (240, 400, 401, 16000, 25123)


def _signal(n, seed=0):
    rng = np.random.default_rng(seed + n)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _logfbank_f64(x):
    """float64 numpy logfbank (python_speech_features' arithmetic)."""
    n = jf.num_frames(len(x))
    pe = np.concatenate([x[:1], x[1:] - np.float32(0.97) * x[:-1]])
    pe = np.pad(pe.astype(np.float64), (0, (n - 1) * 160 + 400 - len(x)))
    frames = np.stack([pe[f * 160:f * 160 + 400] for f in range(n)])
    spec = np.abs(np.fft.rfft(frames, 512)) ** 2 / 512
    return np.log(np.maximum(spec @ tf.mel_filterbank().astype(np.float64),
                             np.finfo(np.float64).eps))


@pytest.mark.parametrize("n", LENGTHS)
def test_logfbank_matches_jax(n):
    """num_frames(S) rows. The port's DFT sums in f64 and holds the exact
    value (rtol 1e-5, atol 1e-4); the JAX DFT sums in f32 and cancels in
    near-null bins, so the two are compared where JAX holds the exact value
    within rtol 1e-4, atol 1e-3 (the test_torch_fbank.py rule)."""
    x = _signal(n)
    got = tf.logfbank(torch.from_numpy(x))
    assert got.shape == (jf.num_frames(n), 200) and got.dtype == torch.float32
    got = got.numpy()
    exact = _logfbank_f64(x)
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
    want = np.asarray(jf.logfbank(jnp.asarray(x)))
    ok = np.isclose(want, exact, rtol=1e-4, atol=1e-3)
    assert ok.mean() > 0.999
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-4, atol=1e-3)


def _scale_f64(feat):
    """sklearn.preprocessing.scale in float64: ddof 0, std 0 -> 1, then
    re-centred."""
    std = feat.std(0)
    std[std == 0] = 1.0
    out = (feat - feat.mean(0)) / std
    return out - out.mean(0)


@pytest.mark.parametrize("n", LENGTHS)
def test_compute_fbank_from_signal_matches_jax(n):
    """logfbank + scale through the batched path at B = 1: num_frames(S)
    rows, within rtol / atol 2e-4 of the float64 value, and of JAX's
    wherever JAX holds that value (test_torch_fbank.py's rule for the
    batched path)."""
    x = _signal(n, 1)
    got = tf.compute_fbank_from_signal(torch.from_numpy(x))
    assert got.shape == (jf.num_frames(n), 200)
    got = got.numpy()
    exact = _scale_f64(_logfbank_f64(x))
    np.testing.assert_allclose(got, exact, rtol=2e-4, atol=2e-4)
    want = np.asarray(jf.compute_fbank_from_signal(jnp.asarray(x)))
    ok = np.isclose(want, exact, rtol=2e-4, atol=2e-4)
    assert ok.mean() > 0.999
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-4, atol=2e-4)
    feats, valid = tf.batched_fbank(torch.from_numpy(x)[None],
                                    torch.tensor([n], dtype=torch.int32))
    assert np.array_equal(feats[0].numpy(), got)
    assert int(valid[0]) == got.shape[0]


@pytest.mark.parametrize("valid", [None, 0, 1, 5, 37, 50])
def test_cmvn_matches_jax(valid):
    """Valid counts of none, 0, 1, inside, T and past T (which divides by
    the count, as the JAX function does)."""
    rng = np.random.default_rng(3)
    feat = (rng.standard_normal((37, 11)) * 3 + 1).astype(np.float32)
    feat[:, 4] = -2.5                                # a constant column
    want = np.asarray(jf.cmvn(jnp.asarray(feat), None if valid is None
                              else jnp.asarray(valid)))
    got = tf.cmvn(torch.from_numpy(feat), valid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if valid is None or valid <= 37:     # past T the mean is sum / valid
        assert np.all(got[:, 4] == 0.0)
    if valid is not None and valid < 37:
        assert np.all(got[valid:] == 0.0)


@pytest.mark.parametrize("fn", ["log_spectrogram", "log_spectrogram_asrt"])
@pytest.mark.parametrize("n", LENGTHS)
def test_spectrograms_match_jax(fn, n):
    """The reference's two Hamming spectrograms: the frame count from the
    pre-emphasised length (+1, or floored), at least one frame; |FFT(400)|
    in complex64 on both sides, so within rtol / atol 1e-4 after log and
    standardisation."""
    x = _signal(n, 2)
    for dim in (200, 161):
        got = getattr(tf, fn)(torch.from_numpy(x), feature_dim=dim)
        want = np.asarray(getattr(jf, fn)(jnp.asarray(x), feature_dim=dim))
        assert got.shape == want.shape and got.shape[1] == dim
        assert got.shape[0] >= 1
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_single_utterance_exports_match_jax():
    names = ("logfbank", "cmvn", "compute_fbank_from_signal",
             "log_spectrogram", "mel_filterbank", "num_frames",
             "FbankConfig", "batched_fbank")
    for name in names:
        assert hasattr(jax_audio, name)
        assert getattr(audio, name) is getattr(tf, name)
    assert audio.log_spectrogram_asrt is tf.log_spectrogram_asrt


def test_inputs_may_be_numpy():
    x = _signal(4000, 3)
    np.testing.assert_array_equal(tf.logfbank(x).numpy(),
                                  tf.logfbank(torch.from_numpy(x)).numpy())
