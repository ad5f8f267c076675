"""The models' backend selectors against the JAX package's: heads wider
than 128 take the plain attention branch where the JAX module takes its
einsum branch; ``fused_attention="einsum"`` does the same at any width;
every selector field of ``TransformerLMConfig`` and
``SpeechTransformerConfig`` refuses an unknown value with the JAX message
when the model is built; ``prenet_conv1_layout="pack"`` builds the model
``"plain"`` builds. f32, small widths, weights bridged by convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_torch.convert import e2e_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                SpeechTransformerConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from tests._torch_cpu import use_two_threads

use_two_threads()

IDS = np.array([[3, 5, 9, 2, 0, 0, 0, 0],
                [7, 7, 7, 7, 7, 7, 7, 6]], np.int32)
E2E_KW = dict(vocab_size=50, d_model=32, num_heads=4, num_enc_blocks=1,
              num_dec_blocks=1, prenet_channels=8, position_max_length=64,
              dropout_rate=0.0)
FD = 18


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _e2e_inputs():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 22, FD, 1)).astype(np.float32)
    valid = np.array([22, 13], np.int32)
    feats[1, 13:] = 0.0
    dec = np.array([[1, 5, 6, 9], [1, 7, 2, 0]], np.int32)
    return feats, valid, dec


@pytest.mark.parametrize("fused", ["auto", "pallas", "einsum"])
def test_wide_heads_lm_matches_jax(fused):
    """d_model 256 in one head (Dh 256, causal, 2 blocks): past the masked
    kernel's Dh <= 128, so both packages take their einsum branch."""
    kw = dict(d_model=256, num_heads=1, num_blocks=2, dropout_rate=0.0,
              fused_attention=fused)
    jlm = jm.TransformerLM(32, 48, dtype=jnp.float32, **kw)
    variables = _np(jax.jit(jlm.init)(jax.random.PRNGKey(3),
                                      jnp.asarray(IDS)))
    want = np.asarray(jax.jit(jlm.apply)(variables, jnp.asarray(IDS)))
    lm = TransformerLM(TransformerLMConfig(32, 48, dtype=torch.float32, **kw),
                       device="cpu")
    lm.load_state_dict(lm_state_dict(variables), strict=True)
    with torch.no_grad():
        got = lm(torch.from_numpy(IDS).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_einsum_lm_trains_as_jax_differentiates():
    """``fused_attention="einsum"`` at Dh 16: the plain branch's gradients
    (torch autograd) against JAX's for the einsum model."""
    kw = dict(d_model=64, num_heads=4, num_blocks=1, dropout_rate=0.0,
              fused_attention="einsum")
    jlm = jm.TransformerLM(32, 48, dtype=jnp.float32, **kw)
    variables = _np(jax.jit(jlm.init)(jax.random.PRNGKey(4),
                                      jnp.asarray(IDS)))
    cot = np.random.default_rng(1).standard_normal((2, 8, 48)).astype(
        np.float32)
    grads = jax.jit(jax.grad(lambda v: jnp.sum(jlm.apply(
        v, jnp.asarray(IDS)) * cot)))(variables)
    want = lm_state_dict(_np(grads))
    lm = TransformerLM(TransformerLMConfig(32, 48, dtype=torch.float32, **kw),
                       device="cpu")
    lm.load_state_dict(lm_state_dict(variables), strict=True)
    (lm(torch.from_numpy(IDS).long()) * torch.from_numpy(cot)).sum().backward()
    for name, p in lm.named_parameters():
        scale = max(float(want[name].abs().max()), 1e-3)
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   want[name].numpy() / scale, atol=1e-5,
                                   err_msg=name)


def test_wide_prenet_matches_jax():
    """``prenet_channels=256``: the pre-net's single heads are 256 wide,
    past the dual kernel's C <= 128 and the masked kernel's Dh <= 128."""
    feats, valid, dec = _e2e_inputs()
    kw = dict(E2E_KW, prenet_channels=256)
    jmod = jm.SpeechTransformer(**kw, dtype=jnp.float32)
    variables = _np(jax.jit(jmod.init)(jax.random.PRNGKey(0), feats, valid,
                                       dec))
    want = jax.jit(jmod.apply)(variables, feats, valid, dec)
    model = SpeechTransformer(SpeechTransformerConfig(**kw,
                                                      dtype=torch.float32),
                              feature_dim=FD, device="cpu")
    model.load_state_dict(e2e_state_dict(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a)
                             for a in (feats, valid, dec)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


LM_FIELDS = [("fused_attention", "unknown attention backend"),
             ("fused_ffn", "unknown ffn backend")]
E2E_FIELDS = [("prenet_fused", "unknown attention backend"),
              ("prenet_conv1_layout", "layout must be auto|plain|pack"),
              ("fused_attention", "unknown attention backend"),
              ("fused_ffn", "unknown ffn backend")]


@pytest.mark.parametrize("field,message", LM_FIELDS)
def test_lm_selectors_reject_unknown_values(field, message):
    kw = dict(d_model=16, num_heads=2, num_blocks=1, **{field: "nope"})
    with pytest.raises(ValueError, match=message):
        jax.jit(jm.TransformerLM(8, 8, dtype=jnp.float32, **kw).init)(
            jax.random.PRNGKey(0), jnp.asarray(IDS % 8))
    with pytest.raises(ValueError, match=message):
        TransformerLM(TransformerLMConfig(8, 8, dtype=torch.float32, **kw),
                      device="cpu")


@pytest.mark.parametrize("field,message", E2E_FIELDS)
def test_e2e_selectors_reject_unknown_values(field, message):
    feats, valid, dec = _e2e_inputs()
    kw = dict(E2E_KW, **{field: "nope"})
    with pytest.raises(ValueError, match=message):
        jax.jit(jm.SpeechTransformer(**kw, dtype=jnp.float32).init)(
            jax.random.PRNGKey(0), feats, valid, dec)
    with pytest.raises(ValueError, match=message):
        SpeechTransformer(SpeechTransformerConfig(**kw, dtype=torch.float32),
                          feature_dim=FD, device="cpu")


def test_pack_layout_builds_the_plain_model():
    """"pack" is an exact re-expression of the stride-2 convolution: the
    same parameters and the same output as "plain" (and "auto")."""
    feats, valid, dec = _e2e_inputs()
    args = [torch.from_numpy(a) for a in (feats, valid, dec)]
    outs, states = [], []
    for layout in ("plain", "pack", "auto"):
        model = SpeechTransformer(
            SpeechTransformerConfig(**E2E_KW, prenet_conv1_layout=layout,
                                    dtype=torch.float32),
            feature_dim=FD, device="cpu").eval()
        states.append(model.state_dict())
        with torch.no_grad():
            outs.append(model(*args))
    for state, out in zip(states[1:], outs[1:]):
        assert state.keys() == states[0].keys()
        assert all(torch.equal(state[k], states[0][k]) for k in state)
        assert torch.equal(out, outs[0])
