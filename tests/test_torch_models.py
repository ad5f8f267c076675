"""The port's SEDFCNN, TransformerLM, their layers, losses, greedy decode
and edit distance against the Flax models and the JAX package's functions
on bridged weights (convert.py), at f32 and small widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_tpu.models.dfcnn import (
    frames_from_samples as jax_frames_from_samples,
)
from asr_dfcnn_transformer_tpu.models.dfcnn import (
    logit_lengths as jax_logit_lengths,
)
from asr_dfcnn_transformer_tpu.models.transformer_lm import (
    lm_loss_and_acc as jax_lm_loss_and_acc,
)
from asr_dfcnn_transformer_tpu.ops.ctc_decode import (
    ctc_greedy_decode as jax_greedy,
)
from asr_dfcnn_transformer_tpu.ops.edit_distance import (
    batched_edit_distance as jax_batched_edit_distance,
)
from asr_dfcnn_transformer_torch.models import layers
from asr_dfcnn_transformer_torch.convert import am_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.models import (
    SEDFCNN,
    SEDFCNNConfig,
    TransformerLM,
    TransformerLMConfig,
    frames_from_samples,
    logit_lengths,
)
from asr_dfcnn_transformer_torch.models.transformer_lm import lm_loss_and_acc
from asr_dfcnn_transformer_torch.ops import (batched_edit_distance,
                                             ctc_greedy_decode, edit_distance)
from tests._torch_cpu import use_two_threads

use_two_threads()


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

    am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **kw), feature_dim=f,
                 device="cpu")
    am.load_state_dict(am_state_dict(variables), strict=True)
    am.eval()               # inference: BatchNorm on the running statistics
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
                                           dtype=torch.float32, **kw),
                       device="cpu")
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
    lm = TransformerLM(TransformerLMConfig(16, 20, dtype=torch.float32, **kw),
                       device="cpu")
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
                                 head_features=8), feature_dim=16,
                   device="cpu")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sd["ConvBnCell_0.Conv_0.weight"].shape == (4, 1, 3, 3)   # OIHW
    assert sd["Dense_0.weight"].shape == (16, 2 * 8)                 # [out, in]
    with pytest.raises(ValueError, match="batch_stats"):
        am_state_dict({"params": _np_tree(variables)["params"]})


@pytest.mark.parametrize("shape,relu", [((4, 3, 5, 6), False),
                                        ((2, 8, 7, 3), True)])
def test_batchnorm_train_matches_flax(shape, relu):
    """Training mode: batch statistics (fast variance, f32) for the output,
    and Flax's momentum-0.99 update of the running statistics with the
    biased variance. ``relu``: non-negative inputs, as the AM's cells give
    their BatchNorms."""
    rng = np.random.default_rng(12)
    b, c, h, w = shape
    x = (rng.standard_normal(shape) * 1.5).astype(np.float32)
    if relu:
        x = np.maximum(x, 0.0)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": (0.1 * rng.standard_normal(c)).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(c).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}
    flax_bn = fnn.BatchNorm(use_running_average=False, epsilon=1e-3,
                            momentum=0.99, dtype=jnp.float32)
    want, upd = flax_bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                              mutable=["batch_stats"])
    want = np.asarray(want).transpose(0, 3, 1, 2)

    bn = layers.BatchNorm(c, dtype=torch.float32, device="cpu")
    bn.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                        "bias": torch.from_numpy(variables["params"]["bias"]),
                        "running_mean": torch.from_numpy(
                            variables["batch_stats"]["mean"]),
                        "running_var": torch.from_numpy(
                            variables["batch_stats"]["var"])})
    bn.train()
    got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)
    # evaluation mode reads the running statistics and changes nothing
    bn.eval()
    before = bn.running_mean.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.running_mean, before)


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_dropout_matches_flax(rate, monkeypatch):
    """The port's Dropout against flax.linen.Dropout on flax's own keep
    mask, injected through the port's ``keep_mask`` hook."""
    rng = np.random.default_rng(13)
    x = rng.uniform(0.5, 1.5, (4, 6, 8)).astype(np.float32)   # no zeros
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        xj = jnp.asarray(x, jdt)
        want = fnn.Dropout(rate).apply({}, xj, deterministic=False,
                                       rngs={"dropout": jax.random.PRNGKey(3)})
        keep = torch.from_numpy(np.asarray(want, np.float32) != 0.0)
        assert 0 < int(keep.sum()) < keep.numel()
        monkeypatch.setattr(layers, "keep_mask",
                            lambda shape, p, device, generator=None: keep)
        drop = layers.Dropout(rate).train()
        got = drop(torch.from_numpy(x).to(dtype))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    xt = torch.from_numpy(x)
    assert layers.Dropout(rate).eval()(xt) is xt
    assert layers.Dropout(0.0).train()(xt) is xt


def test_keep_mask_draws_from_its_generator():
    a = layers.keep_mask((64, 64), 0.7, "cpu",
                         torch.Generator().manual_seed(1))
    b = layers.keep_mask((64, 64), 0.7, "cpu",
                         torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.dtype == torch.bool
    assert abs(float(a.float().mean()) - 0.7) < 0.03


def test_lm_loss_and_acc_matches_jax():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    targets = rng.integers(1, 11, size=(3, 7)).astype(np.int32)
    targets[0, 4:] = 0
    targets[2] = 0                                     # an all-PAD row
    targets[1, 2] = np.argmax(logits[1, 2])            # one sure hit
    want = jax_lm_loss_and_acc(jnp.asarray(logits), jnp.asarray(targets))
    got = lm_loss_and_acc(torch.from_numpy(logits),
                          torch.from_numpy(targets).long())
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(15)
    a = rng.integers(1, 5, size=(6, 9)).astype(np.int32)
    b = rng.integers(1, 5, size=(6, 7)).astype(np.int32)
    a_len = np.array([9, 0, 4, 9, 3, 1], np.int32)
    b_len = np.array([7, 3, 0, 2, 7, 1], np.int32)
    want = np.asarray(jax_batched_edit_distance(
        jnp.asarray(a), jnp.asarray(a_len), jnp.asarray(b),
        jnp.asarray(b_len)))
    got = batched_edit_distance(torch.from_numpy(a), torch.from_numpy(a_len),
                                torch.from_numpy(b), torch.from_numpy(b_len))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    for i in range(6):
        assert edit_distance(list(a[i, :a_len[i]]),
                             list(b[i, :b_len[i]])) == want[i]
