"""The port's low-frame-rate stacking against the JAX package's
``audio/lfr.py``: per utterance and batched, with utterances that end in
the middle of a stacking window."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio.lfr import (
    batched_lfr as jax_batched_lfr,
)
from asr_dfcnn_transformer_tpu.audio.lfr import (
    build_lfr_features as jax_build_lfr,
)
from asr_dfcnn_transformer_torch.audio.lfr import (batched_lfr,
                                                   build_lfr_features,
                                                   lfr_length)
from tests._torch_cpu import use_two_threads

use_two_threads()


@pytest.mark.parametrize("t", [1, 2, 3, 4, 10, 11, 12, 64])
def test_lfr_length(t):
    from asr_dfcnn_transformer_tpu.audio.lfr import lfr_length as jax_len
    assert lfr_length(t) == jax_len(t)
    assert lfr_length(t, 2) == jax_len(t, 2)


@pytest.mark.parametrize("t,m,n", [(11, 4, 3), (12, 4, 3), (1, 4, 3),
                                   (10, 5, 2), (7, 1, 1)])
def test_build_lfr_matches_jax(t, m, n):
    feat = np.random.default_rng(t).standard_normal((t, 6)).astype(
        np.float32)
    want = np.asarray(jax_build_lfr(jnp.asarray(feat), m, n))
    got = build_lfr_features(torch.from_numpy(feat), m, n).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m,n", [(4, 3), (5, 2)])
def test_batched_lfr_matches_jax(m, n):
    """Valid lengths that end mid-window (10, 8, 5 of 13 with m 4, n 3):
    the tail repeats each utterance's own last frame, not the buffer's
    zero padding; rows past ceil(valid / n) are zero."""
    rng = np.random.default_rng(0)
    b, t, d = 4, 13, 5
    feat = rng.standard_normal((b, t, d)).astype(np.float32)
    valid = np.array([13, 10, 8, 5], np.int32)
    for i, v in enumerate(valid):
        feat[i, v:] = 0.0           # a padded batch, as batched_fbank gives
    want, want_valid = jax_batched_lfr(jnp.asarray(feat), jnp.asarray(valid),
                                       m, n)
    got, got_valid = batched_lfr(torch.from_numpy(feat),
                                 torch.from_numpy(valid), m, n)
    assert got_valid.dtype == torch.int32
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each utterance's valid rows are its own build_lfr_features
    for i, v in enumerate(valid):
        rows = int(got_valid[i])
        one = build_lfr_features(torch.from_numpy(feat[i, :v]), m, n)
        np.testing.assert_array_equal(got[i, :rows].numpy(), one.numpy())
        assert not got[i, rows:].any()


def test_batched_lfr_clips_to_own_last_frame():
    """A window crossing the end of a 5-frame utterance in a 9-frame
    buffer repeats frame 4, not the (nonzero) buffer frames past it."""
    feat = torch.arange(9, dtype=torch.float32).view(1, 9, 1) + 1.0
    out, valid = batched_lfr(feat, torch.tensor([5], dtype=torch.int32))
    assert valid.tolist() == [2]
    assert out[0, 1].tolist() == [4.0, 5.0, 5.0, 5.0]
    assert out[0, 2].tolist() == [0.0, 0.0, 0.0, 0.0]
