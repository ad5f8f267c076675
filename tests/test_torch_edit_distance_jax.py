"""``ops.edit_distance.label_error_rate`` and ``models.layers.shift_right``
against the JAX package's functions of the same names, on seeded numpy
inputs with empty labels and empty decodes among them:
``label_error_rate`` at rtol 1e-6, ``shift_right`` exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.models.layers import shift_right as jax_shift
from asr_dfcnn_transformer_tpu.ops.edit_distance import (
    label_error_rate as jax_ler)
from asr_dfcnn_transformer_torch.models.layers import shift_right
from asr_dfcnn_transformer_torch.ops.edit_distance import label_error_rate
from tests._torch_cpu import use_two_threads

use_two_threads()


def _ragged(rng, b, length, vocab, min_len=0):
    """[B, L] int32 ids padded with 0 past random lengths in
    [min_len, L], and the lengths."""
    lens = rng.integers(min_len, length + 1, size=b).astype(np.int32)
    ids = rng.integers(1, vocab, size=(b, length)).astype(np.int32)
    ids[np.arange(length)[None, :] >= lens[:, None]] = 0
    return ids, lens


@pytest.mark.parametrize("seed,b,la,lb,vocab", [
    (0, 8, 12, 10, 5), (1, 16, 7, 15, 3), (2, 5, 1, 1, 2),
    (3, 32, 20, 20, 30)])
def test_label_error_rate_matches_jax(seed, b, la, lb, vocab):
    rng = np.random.default_rng(seed)
    dec, dec_len = _ragged(rng, b, la, vocab)
    lab, lab_len = _ragged(rng, b, lb, vocab)
    lab_len[0], dec_len[1] = 0, 0          # an empty label, an empty decode
    lab[0], dec[1] = 0, 0
    want = np.asarray(jax_ler(jnp.asarray(dec), jnp.asarray(dec_len),
                              jnp.asarray(lab), jnp.asarray(lab_len)))
    got = label_error_rate(torch.from_numpy(dec), torch.from_numpy(dec_len),
                           torch.from_numpy(lab), torch.from_numpy(lab_len))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_label_error_rate_all_empty_labels():
    """Every label empty: each distance over max(0, 1) = its decode's
    length, as in JAX."""
    dec = np.array([[1, 2, 0], [0, 0, 0]], np.int32)
    dec_len = np.array([2, 0], np.int32)
    lab = np.zeros((2, 4), np.int32)
    lab_len = np.zeros(2, np.int32)
    want = np.asarray(jax_ler(*map(jnp.asarray, (dec, dec_len, lab,
                                                 lab_len))))
    got = label_error_rate(*map(torch.from_numpy, (dec, dec_len, lab,
                                                   lab_len)))
    assert float(want) == 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("shape,bos,dtype", [
    ((4, 9), 1, np.int32), ((1, 1), 7, np.int32), ((3, 2), 0, np.int64)])
def test_shift_right_matches_jax(shape, bos, dtype):
    ids = np.random.default_rng(5).integers(0, 50, size=shape).astype(dtype)
    want = np.asarray(jax_shift(jnp.asarray(ids), bos))
    got = shift_right(torch.from_numpy(ids), bos)
    assert got.dtype == torch.from_numpy(ids).dtype
    np.testing.assert_array_equal(got.numpy(), want)
