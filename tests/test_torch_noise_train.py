"""The AM train step with colored noise and SpecAugment
(``AMTrainer(augment_noise=True, augment_spec=...)``): with its draws
replaced by the JAX package's own (noise from one key, masks from another,
as the JAX step splits them), it gives the loss and gradients of the
port's clean step on signals mixed by JAX's ``add_noise_batch`` and masked
by the same SpecAugment draws; the factory passes both options through;
eval steps stay clean; a step draws noise, then masks, from its generator.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from asr_dfcnn_transformer_tpu.audio import noise as jax_noise
from asr_dfcnn_transformer_tpu.audio.specaugment import (
    SpecAugmentConfig as JaxSpecAugmentConfig,
)
from asr_dfcnn_transformer_torch.audio.noise import fft_size, noise_draws
from asr_dfcnn_transformer_torch.audio.specaugment import (SpecAugmentConfig,
                                                           spec_draws)
from asr_dfcnn_transformer_torch.core.config import AmConfig, Config
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
from asr_dfcnn_transformer_torch.train import AMTrainer, factory
from tests._torch_cpu import use_two_threads

use_two_threads()

AM_KW = dict(vocab_size=24, stage_features=(4, 4, 8, 8, 8),
             se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0)
BUCKET = 64
FEATS = 40
# wide bands against 64 frames, so that the masks cut real frames
SPEC = dict(num_freq_masks=2, max_freq_width=8, num_time_masks=2,
            max_time_width=20, max_time_frac=0.2)


def jax_draws(key, b, s):
    """``add_noise_batch``'s draws from ``key``: (SNRs [B], alpha indices
    [B], re, im [B, nbins]), as tests/test_torch_noise.py reproduces them."""
    keys = jax.random.split(key, 3)
    snr = jax.random.randint(keys[0], (b,), 5, 11)
    alpha_idx = jax.random.randint(keys[1], (b,), 0, 21)
    nbins = fft_size(s) // 2 + 1
    halves = [jax.random.split(k) for k in jax.random.split(keys[2], b)]
    re, im = (jnp.stack([jax.random.normal(h[i], (nbins,), jnp.float32)
                         for h in halves]) for i in (0, 1))
    return tuple(np.array(a) for a in (snr, alpha_idx, re, im))


def jax_spec_draws(key, b, cfg):
    """``spec_augment``'s four uniform [B, M] draws from ``key``, as
    tests/test_torch_specaugment.py reproduces them."""
    kf, kt = jax.random.split(key)
    out = []
    for k, m in ((kf, cfg.num_freq_masks), (kt, cfg.num_time_masks)):
        kw, ks = jax.random.split(k)
        out += [np.array(jax.random.uniform(kw, (b, m))),
                np.array(jax.random.uniform(ks, (b, m)))]
    return out


def _batch(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    n = (BUCKET - 1) * 160 + 400
    lens = np.array([n, 9000, 7000, 4000][:batch], np.int32)
    t = np.arange(n) / 16000.0
    sig = np.zeros((batch, n), np.float32)
    for i, m in enumerate(lens):
        sig[i, :m] = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400)
                                   * t[:m]) + 0.01 * rng.standard_normal(m))
    frames = (1 + np.ceil((lens - 400) / 160)).astype(np.int32)
    pinyin = np.zeros((batch, 4), np.int32)
    pny_len = np.array([3, 2, 1, 2][:batch], np.int32)
    for i, m in enumerate(pny_len):
        pinyin[i, :m] = rng.integers(1, AM_KW["vocab_size"] - 1, m)
    weights = np.ones(batch, np.float32)
    weights[-1] = 0.0
    return AMBatch(sig, lens, frames, pinyin, pny_len, pinyin.copy(),
                   pny_len.copy(), weights, BUCKET)


def _model(seed=0):
    return SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **AM_KW),
                   feature_dim=FEATS, device="cpu",
                   generator=torch.Generator().manual_seed(seed))


def _trainer(model, workdir, **kw):
    return AMTrainer(copy.deepcopy(model), str(workdir), lr=7e-4,
                     feature_dim=FEATS, **kw)


def test_noisy_step_matches_clean_step_on_jax_mixed_signals(tmp_path):
    batch = _batch()
    b, s = batch.signals.shape
    nkey, skey = jax.random.split(jax.random.PRNGKey(3))
    noise = tuple(torch.from_numpy(a) for a in jax_draws(nkey, b, s))
    cfg = SpecAugmentConfig(**SPEC)
    spec = [torch.from_numpy(u) for u in jax_spec_draws(
        skey, b, JaxSpecAugmentConfig(**SPEC))]
    mixed = np.array(jax_noise.add_noise_batch(
        nkey, jnp.asarray(batch.signals), jnp.asarray(batch.signal_lengths)))
    model = _model()

    noisy = _trainer(model, tmp_path / "noisy", augment_noise=True,
                     augment_spec=cfg)
    noisy.augment_draws = lambda *a: (noise, spec)
    clean = _trainer(model, tmp_path / "clean", augment_spec=cfg)
    clean.augment_draws = lambda *a: (None, spec)
    got = float(noisy.train_step(batch)["loss"])
    want = float(clean.train_step(AMBatch(**dict(
        vars(batch), signals=mixed)))["loss"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    plain = _trainer(model, tmp_path / "plain")
    assert abs(float(plain.train_step(batch)["loss"]) - want) > 1e-3
    # the gradients (Adam's first step is sign(g)-like and would hide
    # them), to tests/test_torch_train.py's tolerances: the mixtures differ
    # in the last bits, so the f32 sums do too
    for (name, p), q in zip(noisy.model.named_parameters(),
                            clean.model.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=name)


def test_step_draws_noise_then_masks_from_its_generator(tmp_path):
    tr = _trainer(_model(), tmp_path, augment_noise=True, augment_spec=True)
    assert tr.augment_spec == SpecAugmentConfig()
    noise, spec = tr.augment_draws(3, 5000, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    want_noise = noise_draws(3, 5000, gen)
    want_spec = spec_draws(3, SpecAugmentConfig(), gen)
    for g, w in zip((*noise, *spec), (*want_noise, *want_spec)):
        assert torch.equal(g, w)
    assert _trainer(_model(), tmp_path / "off").augment_draws(3, 5000) == (
        None, None)


def test_seeded_noisy_steps_repeat(tmp_path):
    batch = _batch(1)
    model = _model(1)
    losses = []
    for i, seed in enumerate((5, 5, 6)):
        tr = _trainer(model, tmp_path / str(i), augment_noise=True,
                      augment_spec=True)
        losses.append(float(tr.train_step(
            batch, torch.Generator().manual_seed(seed))["loss"]))
    assert losses[0] == losses[1] != losses[2]


def test_eval_stays_clean(tmp_path):
    batch = _batch(2)
    model = _model(2)
    noisy = _trainer(model, tmp_path / "noisy", augment_noise=True,
                     augment_spec=True)

    def refuse(*a):
        raise AssertionError("an eval step drew augmentation")
    noisy.augment_draws = refuse
    got = noisy.eval_step(batch)
    want = _trainer(model, tmp_path / "clean").eval_step(batch)
    for key in ("loss", "ler", "weight"):
        assert torch.equal(got[key], want[key]), key


def test_build_am_trainer_passes_both_options(tmp_path):
    cfg = Config(am=AmConfig(feature_dim=FEATS))
    tr = factory.build_am_trainer(cfg, str(tmp_path / "a"),
                                  augment_noise=True, augment_spec=True,
                                  device="cpu")
    assert tr.augment_noise and tr.augment_spec == SpecAugmentConfig()
    cfg_spec = SpecAugmentConfig(**SPEC)
    tr = factory.build_am_trainer(cfg, str(tmp_path / "b"),
                                  augment_spec=cfg_spec, device="cpu")
    assert not tr.augment_noise and tr.augment_spec is cfg_spec
    tr = factory.build_am_trainer(cfg, str(tmp_path / "c"), device="cpu")
    assert not tr.augment_noise and tr.augment_spec is None
