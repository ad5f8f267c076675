"""The port's SpecAugment against the JAX package's: on JAX's own uniform
draws, reproduced here from the key by ``spec_augment``'s splits, the masked
features are bit-equal; with a seeded ``torch.Generator`` the masks repeat
and stay inside each utterance's valid frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio.specaugment import (
    SpecAugmentConfig as JaxSpecAugmentConfig,
)
from asr_dfcnn_transformer_tpu.audio.specaugment import (
    spec_augment as jax_spec_augment,
)
from asr_dfcnn_transformer_torch.audio.specaugment import (SpecAugmentConfig,
                                                           mask_features,
                                                           rand_bands,
                                                           spec_augment)
from tests._torch_cpu import use_two_threads

use_two_threads()

B, T, F = 5, 120, 40
VALID = np.array([120, 90, 37, 3, 0], np.int32)
# a policy whose bands are wide against these sizes, so that both the
# adaptive time cap and the room left for the start come into play
CFG = dict(num_freq_masks=3, max_freq_width=12, num_time_masks=2,
           max_time_width=30, max_time_frac=0.2)


def _jax_draws(key, b, cfg):
    """The four uniform [B, M] arrays ``spec_augment`` draws from ``key``:
    (frequency widths, starts, time widths, starts)."""
    kf, kt = jax.random.split(key)
    out = []
    for k, m in ((kf, cfg.num_freq_masks), (kt, cfg.num_time_masks)):
        kw, ks = jax.random.split(k)
        out += [np.array(jax.random.uniform(kw, (b, m))),
                np.array(jax.random.uniform(ks, (b, m)))]
    return out


def _feats(seed=0):
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(
        np.float32)


def test_config_matches_jax():
    assert dataclasses.asdict(SpecAugmentConfig()) == dataclasses.asdict(
        JaxSpecAugmentConfig())


@pytest.mark.parametrize("nhwc", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_masks_bit_equal_on_jax_draws(nhwc, with_valid, seed):
    feats = _feats(seed)
    if nhwc:
        feats = feats[..., None]
    valid = VALID if with_valid else None
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_spec_augment(
        key, jnp.asarray(feats), None if valid is None else jnp.asarray(valid),
        JaxSpecAugmentConfig(**CFG)))
    draws = [torch.from_numpy(u) for u in _jax_draws(
        key, B, JaxSpecAugmentConfig(**CFG))]
    got = mask_features(torch.from_numpy(feats),
                        None if valid is None else torch.from_numpy(valid),
                        SpecAugmentConfig(**CFG), draws)
    assert got.shape == feats.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).any()        # some band did mask


def test_band_edges():
    """u = 0 gives an empty band at 0; u just below 1 the widest band at
    the last start; the u == 1.0 guard keeps a band inside its limit."""
    lim = torch.tensor([[10], [10], [10]], dtype=torch.int32)
    wmax = torch.tensor([[4], [4], [4]], dtype=torch.int32)
    u = torch.tensor([[0.0], [np.nextafter(np.float32(1), 0)], [1.0]])
    starts, widths = rand_bands(u, u, wmax, lim)
    assert widths[:, 0].tolist() == [0, 4, 4]
    assert starts[:, 0].tolist() == [0, 6, 6]


def test_seeded_and_inside_valid_frames():
    feats = torch.from_numpy(_feats(3))
    valid = torch.from_numpy(VALID)
    cfg = SpecAugmentConfig(**CFG)
    a = spec_augment(feats, valid, cfg, torch.Generator().manual_seed(4))
    b = spec_augment(feats, valid, cfg, torch.Generator().manual_seed(4))
    c = spec_augment(feats, valid, cfg, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    for x in (a, c):
        changed = x != feats
        freq_band = changed.all(dim=1)                      # [B, F]
        time_rows = (changed & ~freq_band[:, None, :]).any(dim=2)
        for i, n in enumerate(VALID.tolist()):
            assert not time_rows[i, n:].any()               # inside valid
    # the default policy on 200-bin, 1600-frame features
    big = torch.randn(2, 1600, 200, generator=torch.Generator().manual_seed(6))
    out = spec_augment(big, torch.tensor([1600, 800]), SpecAugmentConfig(),
                       torch.Generator().manual_seed(7))
    assert out.shape == big.shape and bool((out == 0).any())
