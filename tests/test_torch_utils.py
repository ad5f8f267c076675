"""The port's host-side utilities against the JAX package's: the lexicon
(``core/lexicon.py``), phonemization (``utils/phoneme.py``), the plot
helpers (``utils/plotting.py``; skipped without matplotlib) and the
attention maps of ``utils/introspect.py`` for the LM, CTC-attention and
the speech Transformer on bridged weights, with and without the capture
around the card's kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.core.lexicon import Lexicon as JaxLexicon
from asr_dfcnn_transformer_tpu.utils import attention_maps as jax_maps
from asr_dfcnn_transformer_tpu.utils import phoneme as jph
from asr_dfcnn_transformer_torch import models as tm
from asr_dfcnn_transformer_torch.convert import flax_to_state_dict
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.core.lexicon import Lexicon
from asr_dfcnn_transformer_torch.models.layers import capture_attention
from asr_dfcnn_transformer_torch.utils import attention_maps, phoneme
from tests._torch_cpu import use_two_threads

use_two_threads()


def test_lexicon_matches_jax():
    lx, jlx = Lexicon(), JaxLexicon()
    assert lx.table == jlx.table and len(lx.table) > 1000
    pinyin = ["ni3", "hao3", "zhong1", "guo2", "not-a-syllable"]
    assert lx.first_candidate_transcription(pinyin) == \
        jlx.first_candidate_transcription(pinyin)
    assert lx.first_candidate_transcription(pinyin).endswith("?")
    assert lx.validate(pinyin[:2], "你好") == jlx.validate(pinyin[:2], "你好")
    # every toned syllable of the acoustic vocabulary but the blank
    missing = [s for s in vocab.acoustic_vocab().symbols[:-1]
               if not lx.candidates(s)]
    jmissing = [s for s in vocab.acoustic_vocab().symbols[:-1]
                if not jlx.candidates(s)]
    assert missing == jmissing


def test_phoneme_matches_jax():
    syllables = list(vocab.acoustic_vocab().symbols[:-1])
    for s in syllables:
        assert phoneme.split_pinyin(s) == jph.split_pinyin(s), s
    assert phoneme.phonemize_pinyin(syllables[:50]) == \
        jph.phonemize_pinyin(syllables[:50])
    assert phoneme.phoneme_inventory(syllables) == \
        jph.phoneme_inventory(syllables)
    text = "中国人民你好世界ab"
    for tones in (True, False):
        assert phoneme.HanziPhonemizer().phonemize(text, tones) == \
            jph.HanziPhonemizer().phonemize(text, tones)
    with pytest.raises(ValueError):
        phoneme.split_pinyin("4")


def test_plotting_matches_jax(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from asr_dfcnn_transformer_tpu.utils import plotting as jplot
    from asr_dfcnn_transformer_torch.utils import plotting
    t = np.arange(1600) / 16000.0
    sine = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    for name in ("plot_time", "plot_freq"):
        a = getattr(plotting, name)(sine, 16000)
        b = getattr(jplot, name)(sine, 16000)
        (la,), (lb,) = a.axes[0].get_lines(), b.axes[0].get_lines()
        for x, y in zip(la.get_data(), lb.get_data()):
            np.testing.assert_array_equal(x, y)
        matplotlib.pyplot.close(a)
        matplotlib.pyplot.close(b)
    spec = np.random.default_rng(0).standard_normal((20, 8))
    fig = plotting.plot_spectrogram(torch.from_numpy(spec).numpy())
    path = str(tmp_path / "spec.png")
    plotting.save_figure(fig, path)
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"


def _check(got, want, shapes):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert tuple(got[k].shape) == shapes[k], k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_lm_attention_maps_match_jax():
    flax_lm = jm.TransformerLM(20, 30, d_model=16, num_heads=2,
                               num_blocks=2, dropout_rate=0.0,
                               dtype=jnp.float32)
    ids = np.array([[3, 4, 5, 0], [7, 0, 0, 0]], np.int32)
    variables = jax.jit(flax_lm.init)(jax.random.PRNGKey(0), ids)
    want = jax.jit(lambda v, i: jax_maps(flax_lm, v, i, train=False))(
        variables, ids)
    lm = tm.TransformerLM(tm.TransformerLMConfig(
        20, 30, d_model=16, num_heads=2, num_blocks=2, dropout_rate=0.0,
        dtype=torch.float32), device="cpu")
    lm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                       variables)))
    lm.eval()
    got = attention_maps(lm, torch.from_numpy(ids).long())
    _check(got, want, {k: (2, 2, 4, 4) for k in want})
    p = got["block0_0_attn"][0, 0].numpy()
    assert p[0, 1] < 1e-6 and p[1, 3] < 1e-6          # causal
    # outside a capture the model computes the same logits as inside
    with torch.no_grad():
        plain = lm(torch.from_numpy(ids).long())
        with capture_attention(lm) as maps:
            captured = lm(torch.from_numpy(ids).long())
    assert set(maps) == set(want)
    torch.testing.assert_close(plain, captured, rtol=1e-5, atol=1e-5)


def test_speech_transformer_attention_maps_match_jax():
    kw = dict(d_model=32, num_heads=4, num_enc_blocks=1, num_dec_blocks=1,
              prenet_channels=8, dropout_rate=0.0)
    ev = 50
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 24, 160, 1)).astype(np.float32)
    valid = np.array([24, 15], np.int32)
    dec_in = np.array([[1, 5, 6, 7], [1, 9, 0, 0]], np.int32)
    flax_m = jm.SpeechTransformer(ev, dtype=jnp.float32, **kw)
    args = (jnp.asarray(feats), jnp.asarray(valid), jnp.asarray(dec_in))
    variables = jax.tree.map(np.asarray, jax.jit(flax_m.init)(
        jax.random.PRNGKey(0), *args))
    want = jax.jit(lambda v, *a: jax_maps(flax_m, v, *a, train=False))(
        variables, *args)
    m = tm.SpeechTransformer(tm.SpeechTransformerConfig(
        ev, dtype=torch.float32, **kw), feature_dim=160, device="cpu")
    m.load_state_dict(flax_to_state_dict(variables), strict=True)
    m.eval()
    got = attention_maps(m, torch.from_numpy(feats), torch.from_numpy(valid),
                         torch.from_numpy(dec_in).long())
    _check(got, want, {k: tuple(np.asarray(v).shape)
                       for k, v in want.items()})
    assert {"enc_attn_0", "dec_self_0", "dec_cross_0"} <= set(got)
