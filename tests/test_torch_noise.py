"""The port's colored-noise augmentation (``audio/noise.py``) against the
JAX package's: on JAX's own draws, reproduced here from the key by
``add_noise_batch``'s and ``color_noise``'s splits, the mixtures agree
within 1e-5 of each signal's peak and the SNRs and alphas are equal; the
matfft branch agrees with JAX's when both take it; seeded generators
repeat; the statistics of tests/test_noise.py hold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio import noise as jax_noise
from asr_dfcnn_transformer_torch.audio import noise
from tests._torch_cpu import use_two_threads

use_two_threads()


def jax_draws(key, b, s, snr_db_range=(5, 10), alpha_range=(-1.0, 1.0)):
    """``add_noise_batch``'s draws from ``key`` as numpy: (SNRs [B], alpha
    indices [B], re, im [B, nbins])."""
    keys = jax.random.split(key, 3)
    snr = jax.random.randint(keys[0], (b,), snr_db_range[0],
                             snr_db_range[1] + 1)
    n_alpha = noise.alpha_grid_size(alpha_range)
    alpha_idx = jax.random.randint(keys[1], (b,), 0, n_alpha)
    nbins = noise.fft_size(s) // 2 + 1
    re, im = [], []
    for k in jax.random.split(keys[2], b):
        kr, ki = jax.random.split(k)
        re.append(jax.random.normal(kr, (nbins,), jnp.float32))
        im.append(jax.random.normal(ki, (nbins,), jnp.float32))
    return tuple(np.array(a) for a in (snr, alpha_idx, jnp.stack(re),
                                         jnp.stack(im)))


def _to_torch(draws):
    return tuple(torch.from_numpy(np.array(d)) for d in draws)


def _signals(seed, b, s):
    rng = np.random.default_rng(seed)
    sig = (0.1 * rng.standard_normal((b, s))).astype(np.float32)
    lengths = np.array([s, s - 1, s // 2, 301][:b], np.int32)
    for i, n in enumerate(lengths):
        sig[i, n:] = 0.0
    return sig, lengths


@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("s", [2048, 3000])
def test_mixtures_match_jax_on_jax_draws(s, with_lengths):
    sig, lengths = _signals(s, 4, s)
    key = jax.random.PRNGKey(s)
    lens = lengths if with_lengths else None
    want = np.asarray(jax_noise.add_noise_batch(
        key, jnp.asarray(sig), None if lens is None else jnp.asarray(lens)))
    draws = _to_torch(jax_draws(key, 4, s))
    got = noise.add_noise_from_draws(
        torch.from_numpy(sig), None if lens is None else
        torch.from_numpy(lens), draws).numpy()
    assert got.shape == sig.shape and got.dtype == np.float32
    peak = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-5 * peak).all()
    if with_lengths:
        for i, n in enumerate(lengths):
            assert (got[i, n:] == 0).all()


def test_snr_and_alpha_equal_jax():
    """The SNR integers and the f32 alphas the port forms from the draws
    are JAX's exactly."""
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, 3)
    b = 64
    snr_j = np.asarray(jax.random.randint(keys[0], (b,), 5, 11))
    alpha_j = np.asarray(-1.0 + 0.1 * jax.random.randint(keys[1], (b,), 0,
                                                          21))
    snr, alpha_idx, _, _ = jax_draws(key, b, 16)
    np.testing.assert_array_equal(snr, snr_j)
    alpha = noise.alpha_of(torch.from_numpy(alpha_idx))
    assert alpha.dtype == torch.float32
    np.testing.assert_array_equal(alpha.numpy(), alpha_j)
    assert np.isin(np.round(alpha.numpy() * 10), np.arange(-10, 11)).all()


@pytest.mark.parametrize("alpha", [-0.7, 0.0, 1.0])
def test_color_noise_matches_jax(alpha):
    key = jax.random.PRNGKey(9)
    length = 3000
    want = np.asarray(jax_noise.color_noise(key, length, jnp.float32(alpha)))
    kr, ki = jax.random.split(key)
    nbins = noise.fft_size(length) // 2 + 1
    re, im = (torch.from_numpy(np.array(jax.random.normal(
        k, (nbins,), jnp.float32)))[None] for k in (kr, ki))
    got = noise.color_noise(re, im, torch.tensor([alpha]), length)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_color_noise_matfft_branch_matches_jax(monkeypatch):
    """Both packages forced onto the matfft branch (bf16 compute, "auto"
    epilogue), the tests/test_matfft.py:70 pattern: the noise agrees with
    JAX's to bf16-DFT tolerance and tracks the FFT branch."""
    key = jax.random.PRNGKey(9)
    length, alpha = 3000, -0.7
    kr, ki = jax.random.split(key)
    nbins = noise.fft_size(length) // 2 + 1
    re, im = (torch.from_numpy(np.array(jax.random.normal(
        k, (nbins,), jnp.float32)))[None] for k in (kr, ki))
    fft = noise.color_noise(re, im, torch.tensor([alpha]), length)[0]
    monkeypatch.setattr(jax_noise, "_use_matfft", lambda: True)
    monkeypatch.setattr(noise, "_use_matfft", lambda: True)
    want = np.asarray(jax_noise.color_noise(key, length, jnp.float32(alpha)))
    got = noise.color_noise(re, im, torch.tensor([alpha]), length)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=0.03)
    assert np.corrcoef(got.numpy(), want)[0, 1] > 0.999
    np.testing.assert_allclose(got.numpy(), fft.numpy(), atol=0.03)


def test_seeded_generators_repeat():
    sig, lengths = _signals(1, 4, 2048)
    sig, lengths = torch.from_numpy(sig), torch.from_numpy(lengths)
    runs = [noise.add_noise_batch(sig, lengths,
                                  torch.Generator().manual_seed(seed))
            for seed in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_color_noise_stats():
    """tests/test_noise.py: de-meaned, max-normalised, the spectral tilt."""
    gen = torch.Generator().manual_seed(0)
    n = 8192
    nbins = noise.fft_size(n) // 2 + 1
    re, im = (torch.randn((3, nbins), generator=gen) for _ in range(2))
    x = noise.color_noise(re, im, torch.tensor([-1.0, 0.0, 1.0]), n).numpy()
    assert x.shape == (3, n)
    assert (np.abs(x.mean(axis=1)) < 1e-4).all()
    assert (np.abs(x.max(axis=1) - 1.0) < 1e-4).all()
    spec = np.abs(np.fft.rfft(x, axis=1)) ** 2
    half = spec.shape[1] // 2
    hf = spec[:, half:].sum(axis=1) / spec.sum(axis=1)
    assert hf[0] < 0.1 and hf[2] > 0.8


def test_snr_gain():
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    nse = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    k = float(noise.snr_to_gain(sig, nse, torch.tensor(10.0)))
    snr_db = 10 * np.log10(np.mean(sig.numpy() ** 2)
                           / np.mean((k * nse.numpy()) ** 2))
    assert abs(snr_db - 10.0) < 0.1


def test_add_noise_batch_snr_in_range():
    rng = np.random.default_rng(3)
    sig = torch.from_numpy(
        rng.standard_normal((4, 2048)).astype(np.float32) * 0.1)
    lengths = torch.tensor([2048, 2048, 1500, 1000])
    mixed = noise.add_noise_batch(sig, lengths,
                                  torch.Generator().manual_seed(2)).numpy()
    sig = sig.numpy()
    assert mixed.shape == sig.shape
    assert np.abs(mixed - sig).max() > 0
    assert np.all(mixed[3, 1000:] == 0)
    for i in range(2):
        part = mixed[i] - sig[i]
        snr = 10 * np.log10(np.mean(sig[i] ** 2) / np.mean(part ** 2))
        assert 4.0 < snr < 11.0
