"""The port's SEDFCNN, TransformerLM and greedy decode against the Flax
models on bridged weights (convert.py), at f32 and small widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_tpu.models.dfcnn import (
    frames_from_samples as jax_frames_from_samples,
)
from asr_dfcnn_transformer_tpu.models.dfcnn import (
    logit_lengths as jax_logit_lengths,
)
from asr_dfcnn_transformer_tpu.ops.ctc_decode import (
    ctc_greedy_decode as jax_greedy,
)
from asr_dfcnn_transformer_torch.convert import am_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.models import (
    SEDFCNN,
    SEDFCNNConfig,
    TransformerLM,
    TransformerLMConfig,
    frames_from_samples,
    logit_lengths,
)
from asr_dfcnn_transformer_torch.ops import ctc_greedy_decode

torch.set_num_threads(2)


def _np_tree(variables):
    return jax.tree.map(np.asarray, variables)


def _perturb_stats(variables, seed):
    """Random BatchNorm statistics and scales (init leaves mean 0, var 1,
    scale 1, which would hide a transposed or misnamed leaf)."""
    rng = np.random.default_rng(seed)
    out = _np_tree(variables)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
            elif key in ("mean", "bias"):
                tree[key] = (0.1 * rng.standard_normal(val.shape)
                             ).astype(np.float32)
            elif key == "scale":
                tree[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    walk(out)
    return out


@pytest.mark.parametrize("se_first,space_to_depth", [
    (False, False), (True, False), (False, True)])
def test_sedfcnn_matches_flax(se_first, space_to_depth):
    kw = dict(vocab_size=48, stage_features=(4, 4, 8, 8, 8),
              se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0,
              se_first=se_first, space_to_depth=space_to_depth)
    if space_to_depth:
        kw["stage_pool"] = (True, True, False, False, False)
    b, t, f = 2, 64, 40
    x = np.random.default_rng(1).standard_normal((b, t, f)).astype(np.float32)
    flax_am = JaxSEDFCNN(dtype=jnp.float32, **kw)
    variables = flax_am.init(jax.random.PRNGKey(0), jnp.asarray(x)[..., None])
    variables = _perturb_stats(variables, seed=2)
    want = np.asarray(flax_am.apply(variables, jnp.asarray(x)[..., None]))

    am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **kw), feature_dim=f)
    am.load_state_dict(am_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = am(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == want.shape == (b, t // 8, 48)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused", ["pallas", "einsum"])
def test_transformer_lm_matches_flax(fused):
    ids = np.array([[3, 5, 9, 2, 0, 0, 0, 0],
                    [7, 7, 7, 7, 7, 7, 7, 6],
                    [0, 0, 0, 0, 0, 0, 0, 0]], np.int32)   # PAD-heavy rows
    kw = dict(d_model=64, num_heads=4, num_blocks=2, dropout_rate=0.0)
    flax_lm = JaxLM(32, 48, fused_attention=fused, dtype=jnp.float32, **kw)
    variables = _perturb_stats(
        flax_lm.init(jax.random.PRNGKey(9), jnp.asarray(ids)), seed=3)
    want = np.asarray(flax_lm.apply(variables, jnp.asarray(ids)))

    lm = TransformerLM(TransformerLMConfig(32, 48, fused_attention=fused,
                                           dtype=torch.float32, **kw))
    lm.load_state_dict(lm_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = lm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_two_stack_lm_matches_flax():
    ids = np.array([[4, 1, 9, 0, 0]], np.int32)
    kw = dict(d_model=32, num_heads=2, num_blocks=1, dropout_rate=0.0,
              two_stack=True, causal=False, parity_attention=False)
    flax_lm = JaxLM(16, 20, dtype=jnp.float32, **kw)
    variables = flax_lm.init(jax.random.PRNGKey(5), jnp.asarray(ids))
    want = np.asarray(flax_lm.apply(variables, jnp.asarray(ids)))
    lm = TransformerLM(TransformerLMConfig(16, 20, dtype=torch.float32, **kw))
    lm.load_state_dict(lm_state_dict(_np_tree(variables)), strict=True)
    with torch.inference_mode():
        got = lm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("max_output_len", [None, 5, 100])
def test_ctc_greedy_decode_matches_jax(max_output_len):
    rng = np.random.default_rng(6)
    b, t, v = 4, 30, 7
    # peaked lattice with repeats and blanks (blank = v - 1)
    path = rng.integers(0, v, size=(b, t))
    logits = np.full((b, t, v), -5.0, np.float32)
    np.put_along_axis(logits, path[..., None], 5.0, axis=-1)
    lengths = np.array([30, 17, 1, 0], np.int32)
    want_ids, want_len = jax_greedy(jnp.asarray(logits), jnp.asarray(lengths),
                                    max_output_len=max_output_len)
    got_ids, got_len = ctc_greedy_decode(torch.from_numpy(logits),
                                         torch.from_numpy(lengths),
                                         max_output_len=max_output_len)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_length_helpers_match_jax():
    samples = np.array([0, 1, 400, 401, 560, 561, 16000, 256240], np.int32)
    want = np.asarray(jax_frames_from_samples(jnp.asarray(samples)))
    got = frames_from_samples(torch.from_numpy(samples)).numpy()
    np.testing.assert_array_equal(got, want)
    frames = np.array([1, 7, 8, 100, 1599, 1600, 4000], np.int32)
    np.testing.assert_array_equal(
        logit_lengths(torch.from_numpy(frames), 200).numpy(),
        np.asarray(jax_logit_lengths(jnp.asarray(frames), 200)))


def test_state_dict_layout():
    """The bridge's names and shapes are the port's, leaf for leaf."""
    am = JaxSEDFCNN(vocab_size=16, stage_features=(4, 4, 8, 8, 8),
                    head_features=8, dtype=jnp.float32)
    variables = am.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    sd = am_state_dict(_np_tree(variables))
    port = SEDFCNN(SEDFCNNConfig(16, stage_features=(4, 4, 8, 8, 8),
                                 head_features=8), feature_dim=16)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sd["ConvBnCell_0.Conv_0.weight"].shape == (4, 1, 3, 3)   # OIHW
    assert sd["Dense_0.weight"].shape == (16, 2 * 8)                 # [out, in]
    with pytest.raises(ValueError, match="batch_stats"):
        am_state_dict({"params": _np_tree(variables)["params"]})
