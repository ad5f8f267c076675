"""The port's end-to-end speech Transformer against the JAX package's, on
weights bridged by convert.py, at f32 and small widths: the encoder, the
teacher-forced logits, the KV-cached greedy and beam decodes (and the
port's own full-recompute oracles), every ``parity_decoder`` /
``prenet_masked`` combination and microbatching. ``E2EServing`` against
the JAX serving program: tests/test_torch_e2e_serving.py.

The JAX model runs once with ``prenet_fused="pallas"`` and
``fused_attention="pallas"`` (``dual_axis_attention`` and
``masked_flash_attention`` in interpret mode) and once with "einsum".
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_torch.convert import e2e_state_dict
from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                SpeechTransformerConfig,
                                                beam_decode,
                                                beam_decode_cached,
                                                greedy_decode,
                                                greedy_decode_cached)
from asr_dfcnn_transformer_torch.models import speech_transformer as st
from tests._torch_cpu import use_two_threads

use_two_threads()

KW = dict(vocab_size=50, d_model=32, num_heads=4, num_enc_blocks=2,
          num_dec_blocks=2, prenet_channels=8, position_max_length=64,
          dropout_rate=0.1)
FD = 18          # F 18 -> 9 (odd) -> 5; T 22 -> 11 (odd) -> 6
MAX_LEN = 8
TOL = 1e-4
COMBOS = [(False, True), (True, True), (False, False), (True, False)]


def _jax_model(backend="pallas", parity=False, masked=True, **over):
    return jm.SpeechTransformer(**{**KW, **over}, prenet_fused=backend,
                                fused_attention=backend,
                                parity_decoder=parity, prenet_masked=masked,
                                dtype=jnp.float32)


def _perturb(variables, seed):
    """Random BatchNorm statistics, norm scales and biases (init leaves
    mean 0, var 1, scale 1, bias 0, which would hide a misplaced leaf)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, variables)

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


def _inputs(b=3, t=22, fd=FD, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, fd, 1)).astype(np.float32)
    valid = np.array([t, 15, 7, 11][:b], np.int32)
    for i, v in enumerate(valid):
        feats[i, v:] = 0.0          # padded rows are zero, as batched_lfr's
    dec = np.array([[1, 5, 6, 9], [1, 7, 2, 0], [1, 3, 0, 0],
                    [1, 4, 4, 8]][:b], np.int32)
    return feats, valid, dec


@functools.lru_cache(maxsize=None)
def _variables(parity, fd=FD, perturb=True):
    feats, valid, dec = _inputs(fd=fd)
    v = _jax_model("einsum", parity).init(jax.random.PRNGKey(0), feats,
                                          valid, dec)
    return _perturb(v, 1) if perturb else jax.tree.map(np.asarray, v)


def _port(variables, parity=False, masked=True, fd=FD, **over):
    m = SpeechTransformer(
        SpeechTransformerConfig(**{**KW, **over}, parity_decoder=parity,
                                prenet_masked=masked, dtype=torch.float32),
        feature_dim=fd, device="cpu")
    m.load_state_dict(e2e_state_dict(variables), strict=True)
    return m.eval()


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("backend,parity,masked",
                         [("pallas", p, m) for p, m in COMBOS]
                         + [("einsum", False, True)])
def test_encode_and_logits_match_jax(backend, parity, masked):
    v = _variables(parity)
    jmod = _jax_model(backend, parity, masked)
    model = _port(v, parity, masked)
    feats, valid, dec = _inputs()
    mem_j, mv_j = jmod.apply(v, feats, valid,
                             method=jm.SpeechTransformer.encode)
    logits_j = jmod.apply(v, feats, valid, dec)
    with torch.no_grad():
        mem, mv = model.encode(*_t(feats, valid))
        logits = model(*_t(feats, valid, dec))
    np.testing.assert_array_equal(mv.numpy(), np.asarray(mv_j))
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), atol=TOL,
                               rtol=TOL)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=TOL, rtol=TOL)


def test_same_padding_on_odd_and_even_extents():
    """XLA's SAME at k 3, stride 2 pads (0, 1) on an even extent, (1, 1) on
    an odd one. Here the first conv sees T 21 (odd) and F 16 (even), the
    second T 11 (odd) and F 8 (even); the module tests' (22, 18) input
    gives the other cases."""
    assert st.same_pads(22, 2) == (0, 1) and st.same_pads(11, 2) == (1, 1)
    assert st.same_pads(7, 1) == (1, 1)
    v = _variables(False, fd=16)
    feats, valid, _ = _inputs(t=21, fd=16, seed=4)
    want, _ = _jax_model("einsum").apply(v, feats, valid,
                                         method=jm.SpeechTransformer.encode)
    with torch.no_grad():
        got, _ = _port(v, fd=16).encode(*_t(feats, valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("parity,masked", COMBOS)
def test_cached_decodes_match_jax_and_full_recompute(parity, masked):
    """Greedy and beam (K 3, alpha 0.6): ids and lengths equal to the JAX
    decodes (Pallas attention for the default model, einsum for the other
    flags) and to the port's full-recompute oracles; beam scores close."""
    v = _variables(parity)
    jmod = _jax_model("pallas" if (parity, masked) == COMBOS[0]
                      else "einsum", parity, masked)
    model = _port(v, parity, masked)
    feats, valid, _ = _inputs()
    ids_j, len_j = jm.greedy_decode_cached(jmod, v, feats, valid,
                                           max_len=MAX_LEN)
    ids, lens = greedy_decode_cached(model, *_t(feats, valid),
                                     max_len=MAX_LEN)
    assert ids.dtype == torch.int32 and ids.shape == (3, MAX_LEN)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(len_j))
    full = greedy_decode(model, *_t(feats, valid), max_len=MAX_LEN)
    assert torch.equal(full[0], ids) and torch.equal(full[1], lens)

    bj = jm.beam_decode_cached(jmod, v, feats, valid, beam_size=3,
                               lp_alpha=0.6, max_len=MAX_LEN)
    bt = beam_decode_cached(model, *_t(feats, valid), beam_size=3,
                            lp_alpha=0.6, max_len=MAX_LEN)
    np.testing.assert_array_equal(bt[0].numpy(), np.asarray(bj[0]))
    np.testing.assert_array_equal(bt[1].numpy(), np.asarray(bj[1]))
    np.testing.assert_allclose(bt[2].numpy(), np.asarray(bj[2]), atol=TOL,
                               rtol=TOL)
    bf = beam_decode(model, *_t(feats, valid), beam_size=3, lp_alpha=0.6,
                     max_len=MAX_LEN)
    assert torch.equal(bf[0], bt[0]) and torch.equal(bf[1], bt[1])
    np.testing.assert_allclose(bf[2].numpy(), bt[2].numpy(), atol=TOL,
                               rtol=TOL)


def test_tied_logits_decode_as_jax():
    """A zero output projection makes every logit equal: greedy picks the
    first index, and the beam's K * V = 150 tied candidates go to the lower
    index at every step, as lax.top_k orders them."""
    v = _variables(False)
    out = v["params"]["dec_output"]
    out["kernel"] = np.zeros_like(out["kernel"])
    out["bias"] = np.zeros_like(out["bias"])
    jmod = _jax_model("einsum")
    model = _port(v)
    feats, valid, _ = _inputs()
    for k in (3, 4):
        bj = jm.beam_decode_cached(jmod, v, feats, valid, beam_size=k,
                                   max_len=MAX_LEN)
        bt = beam_decode_cached(model, *_t(feats, valid), beam_size=k,
                                max_len=MAX_LEN)
        for got, want in zip(bt, bj):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=TOL, rtol=TOL)
    gj = jm.greedy_decode_cached(jmod, v, feats, valid, max_len=MAX_LEN)
    gt = greedy_decode_cached(model, *_t(feats, valid), max_len=MAX_LEN)
    np.testing.assert_array_equal(gt[0].numpy(), np.asarray(gj[0]))


def test_top_k_orders_ties_as_lax():
    rng = np.random.default_rng(5)
    x = np.round(rng.standard_normal((6, 300)) * 2) / 2      # many ties
    x[0] = 0.0
    x[1, :] = -1e30
    x = x.astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 7)
    got_v, got_i = st._top_k(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_decode_is_bucket_invariant():
    """The same utterance padded into two buckets decodes identically, and
    its valid encoder rows agree: the pre-net's time keys past the valid
    extent are masked and its invalid rows zeroed (tests/test_models.py).
    The 24 valid rows fill the short bucket, and both buckets halve to even
    extents, so SAME padding aligns the two. As in the JAX test, the
    weights are the initial ones: the pre-net's conv and BatchNorm biases
    are 0, so the long bucket's padding stays 0 through them."""
    model = _port(_variables(False, perturb=False))
    sig = np.random.default_rng(3).standard_normal((1, 24, FD, 1)).astype(
        np.float32)
    valid = torch.tensor([24], dtype=torch.int32)
    short = torch.from_numpy(sig)
    long = torch.zeros((1, 48, FD, 1))
    long[:, :24] = short
    ids_s = greedy_decode_cached(model, short, valid, max_len=MAX_LEN)
    ids_l = greedy_decode_cached(model, long, valid, max_len=MAX_LEN)
    assert torch.equal(ids_s[0], ids_l[0]) and torch.equal(ids_s[1],
                                                           ids_l[1])
    with torch.no_grad():
        mem_s, mv_s = model.encode(short, valid)
        mem_l, _ = model.encode(long, valid)
    nv = int(mv_s[0].sum())
    np.testing.assert_allclose(mem_s[0, :nv].numpy(), mem_l[0, :nv].numpy(),
                               atol=2e-5, rtol=2e-5)


def test_microbatch_is_exact():
    model = _port(_variables(False))
    feats, valid, _ = _inputs(b=4)
    args = _t(feats, valid)
    for decode in (greedy_decode_cached, beam_decode_cached):
        whole = decode(model, *args, max_len=MAX_LEN)
        chunked = decode(model, *args, max_len=MAX_LEN, microbatch=2)
        for a, b in zip(whole, chunked):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="not divisible"):
            decode(model, *args, max_len=MAX_LEN, microbatch=3)


def test_e2e_state_dict_loads_strict():
    v = _variables(False)
    sd = e2e_state_dict(v)
    model = _port(v)
    assert set(sd) == set(model.state_dict())
    assert "prenet.dual_1.time_attn.q.weight" in sd
    assert "enc_attn_1.LayerNorm_0.weight" in sd
    assert "dec_cross_0.k.bias" in sd
    assert "prenet.BatchNorm_1.running_var" in sd
    sd.pop("dec_ffn_1.Dense_1.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="batch_stats"):
        e2e_state_dict({"params": v["params"]})


def test_builds_on_cuda_by_default(monkeypatch):
    """With no device given the model builds on cuda, so without CUDA it
    raises rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SpeechTransformerConfig(**KW, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeechTransformer(cfg, feature_dim=FD)
    model = SpeechTransformer(cfg, feature_dim=FD, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
