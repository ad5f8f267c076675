"""The port's evaluation protocol (``Pipeline.evaluate`` / ``evaluate_lm``),
``recognize_file`` and ``factory.build_loader``, against the JAX package's
on a synthetic corpus with small f32 models on the same weights
(``Pipeline.from_checkpoints`` over a JAX checkpoint converted by
``convert.flax_checkpoint_to_port``: tests/test_torch_eval_jax.py)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.core.config import Config as JaxConfig
from asr_dfcnn_transformer_tpu.data import DataLoader as JaxLoader
from asr_dfcnn_transformer_tpu.data import load_manifests as jax_manifests
from asr_dfcnn_transformer_tpu.data import make_synthetic_corpus
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_tpu.train.factory import (
    build_loader as jax_build_loader)
from asr_dfcnn_transformer_torch.convert import am_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.core.config import Config, DataConfig
from asr_dfcnn_transformer_torch.data import (AMBatch, DataLoader,
                                              load_manifests)
from asr_dfcnn_transformer_torch.infer import EvalResult, Pipeline
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from asr_dfcnn_transformer_torch.train import factory
from tests._torch_cpu import use_two_threads

use_two_threads()

AM_KW = dict(stage_features=(4, 4, 8, 8, 8), se_ratio=(1, 2, 2, 2, 2),
             head_features=8, dropout_rate=0.0)
LM_KW = dict(d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0)
BATCH = 3            # 8 test utterances: the last batch is back-filled


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torcheval")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=2)
    return data_dir, wav_root


def _loaders(corpus, mode="test"):
    data_dir, wav_root = corpus
    jl = JaxLoader(jax_manifests(data_dir, mode, corpora=("thchs",)),
                   jax_vocab.acoustic_vocab(), jax_vocab.language_vocab(),
                   speech_root=wav_root, bucket_bounds=(128,))
    pl = DataLoader(load_manifests(data_dir, mode, corpora=("thchs",)),
                    vocab.acoustic_vocab(), vocab.language_vocab(),
                    speech_root=wav_root, bucket_bounds=(128,))
    return jl, pl


def _port_models(am_vars=None, lm_vars=None, **am_over):
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    am = SEDFCNN(SEDFCNNConfig(av.size, dtype=torch.float32,
                               **{**AM_KW, **am_over}), device="cpu")
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size,
                                           dtype=torch.float32, **LM_KW),
                       device="cpu")
    if am_vars is not None:
        am.load_state_dict(am_state_dict(jax.tree.map(np.asarray, am_vars)))
        lm.load_state_dict(lm_state_dict(jax.tree.map(np.asarray, lm_vars)))
    return am, lm


def _jax_models():
    av, lv = jax_vocab.acoustic_vocab(), jax_vocab.language_vocab()
    return (JaxSEDFCNN(vocab_size=av.size, dtype=jnp.float32, **AM_KW),
            JaxLM(av.size, lv.size, dtype=jnp.float32, **LM_KW))


@pytest.fixture(scope="module")
def pipes(corpus):
    """{decode: (JAX pipeline, port pipeline)} on the same random weights
    (the fixture of tests/test_torch_pipeline.py)."""
    jam, jlm = _jax_models()
    am_vars = jax.jit(jam.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 128, 200, 1)))
    lm_vars = jax.jit(jlm.init)(jax.random.PRNGKey(1),
                                jnp.zeros((1, 8), jnp.int32))
    am, lm = _port_models(am_vars, lm_vars)
    out = {}
    for decode in ("greedy", "beam"):
        out[decode] = (
            JaxPipeline(jam, am_vars, jlm, lm_vars,
                        acoustic_vocab=jax_vocab.acoustic_vocab(),
                        language_vocab=jax_vocab.language_vocab(),
                        decode=decode),
            Pipeline(am, lm, acoustic_vocab=vocab.acoustic_vocab(),
                     language_vocab=vocab.language_vocab(), decode=decode))
    return out


def _same_result(got: EvalResult, want, got_log: str, want_log: str):
    for f in ("pinyin_accuracy", "hanzi_accuracy"):
        g, w = getattr(got, f), getattr(want, f)
        assert (math.isnan(g) and math.isnan(w)) or g == w, f
    assert got.num_utterances == want.num_utterances
    with open(got_log, encoding="utf-8") as f:
        g = f.read()
    with open(want_log, encoding="utf-8") as f:
        assert g == f.read()
    return g


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_evaluate_matches_jax(tmp_path, corpus, pipes, decode):
    jax_pipe, pipe = pipes[decode]
    jl, pl = _loaders(corpus)
    want = jax_pipe.evaluate(jl.am_batches(BATCH, shuffle=False),
                             pred_log_path=str(tmp_path / "jax" / "log"))
    got = pipe.evaluate(pl.am_batches(BATCH, shuffle=False),
                        pred_log_path=str(tmp_path / "port" / "log"))
    text = _same_result(got, want, got.pred_log_path, want.pred_log_path)
    assert got.num_utterances == 8
    assert text.count("\n") == 4 * 8 + 2
    assert "预测拼音结果: " in text and "*[Test Result] 汉字" in text


def test_evaluate_lm_matches_jax(tmp_path, corpus, pipes):
    jax_pipe, pipe = pipes["greedy"]
    jl, pl = _loaders(corpus)
    want = jax_pipe.evaluate_lm(jl.lm_batches(BATCH, shuffle=False),
                                pred_log_path=str(tmp_path / "jax"))
    got = pipe.evaluate_lm(pl.lm_batches(BATCH, shuffle=False),
                           pred_log_path=str(tmp_path / "port"))
    text = _same_result(got, want, got.pred_log_path, want.pred_log_path)
    assert got.num_utterances == 8 and text.count("\n") == 2 * 8 + 1


def test_recognize_file_matches_jax(corpus, pipes):
    _, wav_root = corpus
    for decode in ("greedy", "beam"):
        jax_pipe, pipe = pipes[decode]
        for i in (0, 5):
            path = f"{wav_root}/test/utt_{i}.wav"
            got = pipe.recognize_file(path)
            assert got == jax_pipe.recognize_file(path)
            assert len(got[0]) > 0 and isinstance(got[1], str)


def _fixed_batches():
    """Two batches with hand-set references and decodes: an exact match, a
    hypothesis longer than its reference (its distance clipped), a
    zero-length decode, an empty reference, a reversed reference (its
    distance ties the reference length), and a back-filled row of weight
    0 whose decode would count if it were scored. Returns [(batch,
    (pinyin ids, pinyin lengths, hanzi ids))]."""
    rng = np.random.default_rng(7)
    out = []
    for b, (ref_len, hyp_len, weights) in enumerate((
            ([3, 2, 4, 0, 5], [3, 9, 0, 2, 5], [1, 1, 1, 1, 0]),
            ([1, 6, 2, 2, 3], [1, 2, 12, 2, 3], [1, 1, 1, 1, 1]))):
        n = len(ref_len)
        pny = np.zeros((n, 8), np.int32)
        han = np.zeros((n, 8), np.int32)
        ids = np.zeros((n, 16), np.int32)
        hz = np.zeros((n, 16), np.int32)
        for j, (r, h) in enumerate(zip(ref_len, hyp_len)):
            pny[j, :r] = rng.integers(1, 40, r)
            han[j, :r] = rng.integers(1, 60, r)
            ids[j, :h] = rng.integers(1, 40, h)
            hz[j, :h] = rng.integers(1, 60, h)
        ids[0, :3], hz[0, :3] = pny[0, :3], han[0, :3]    # exact
        if b == 1:                                        # equal distances
            ids[3, :2], hz[3, :2] = pny[3, ::-1][-2:], han[3, ::-1][-2:]
        ref = np.array(ref_len, np.int32)
        batch = AMBatch(np.zeros((n, 16), np.float32), np.full(n, 16),
                        np.ones(n, np.int32), pny, ref, han, ref,
                        np.array(weights, np.float32), 128)
        out.append((batch, (ids, np.array(hyp_len, np.int32), hz)))
    return out


@pytest.mark.parametrize("with_lm", [True, False])
def test_protocol_alone_matches_jax(tmp_path, pipes, with_lm):
    """Both packages' ``evaluate`` on the same fixed decodes: the same
    result and the same pred_log (the recognizers are replaced)."""
    jax_pipe, pipe = pipes["greedy"]
    fixed = _fixed_batches()
    if not with_lm:
        fixed = [(b, (i, n, None)) for b, (i, n, _) in fixed]
        jax_pipe = JaxPipeline(jax_pipe.am_model, jax_pipe.am_variables,
                               acoustic_vocab=jax_pipe.av)
        pipe = Pipeline(pipe.am_model, acoustic_vocab=pipe.av)
    outs = iter([o for _, o in fixed] * 2)
    jax_pipe.recognize_batch = lambda *a: next(outs)
    pipe.recognize_batch = lambda *a: next(outs)
    try:
        want = jax_pipe.evaluate([b for b, _ in fixed],
                                 pred_log_path=str(tmp_path / "jax"))
        got = pipe.evaluate([b for b, _ in fixed],
                            pred_log_path=str(tmp_path / "port"))
    finally:
        del jax_pipe.recognize_batch, pipe.recognize_batch
    text = _same_result(got, want, got.pred_log_path, want.pred_log_path)
    assert got.num_utterances == 9
    assert 0.0 < got.pinyin_accuracy < 1.0
    assert math.isnan(got.hanzi_accuracy) != with_lm
    assert text.count("\n") == (4 * 9 + 2 if with_lm else 2 * 9 + 1)


@pytest.mark.parametrize("mode,shuffle", [("train", True), ("test", False)])
def test_build_loader_matches_jax(corpus, mode, shuffle):
    data_dir, wav_root = corpus
    data = dict(data_dir=data_dir, speech_data_root=wav_root,
                corpora=("thchs",), bucket_bounds=(128,), data_length=7)
    port = factory.build_loader(Config(data=DataConfig(**data)), mode,
                                shuffle=shuffle)
    ref = jax_build_loader(JaxConfig().replace(data=dataclasses.replace(
        JaxConfig().data, **data)), mode, shuffle=shuffle)
    assert port.manifest.paths == ref.manifest.paths
    for got, want in ((port.am_batches(3, seed=1), ref.am_batches(3, seed=1)),
                      (port.lm_batches(3, seed=1), ref.lm_batches(3, seed=1))):
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for f in w._fields if hasattr(w, "_fields") else \
                    [f.name for f in dataclasses.fields(w)]:
                np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                              np.asarray(getattr(w, f)),
                                              err_msg=f)
