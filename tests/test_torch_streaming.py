"""The port's incremental streaming decode (``infer/streaming.py``): against
the JAX package's ``IncrementalRecognizer`` on bridged weights, and against
its own offline ``Pipeline`` case for case as tests/test_streaming.py holds
the JAX one.

The exactness class is a conv-only CTC model (``TinyConvCTC``, the JAX
tests' model, in torch below; the two share weights through convert.py):
with the utterance's own CMVN statistics the streamed final tokens equal
the offline decode; with running CMVN they do not depend on how the audio
was chunked; partials grow into the final hypothesis. The SE drift test (slow) trains a
port SE-DFCNN and measures the streamed-vs-offline agreement, as
tests/test_streaming_se_drift.py does for the JAX package.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.infer.streaming import (
    IncrementalRecognizer as JaxIncrementalRecognizer)
from asr_dfcnn_transformer_tpu.models import (
    TransformerLM as JaxTransformerLM)
from asr_dfcnn_transformer_torch.audio.fbank import FbankConfig, logfbank
from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.infer import Pipeline
from asr_dfcnn_transformer_torch.infer.streaming import (
    IncrementalRecognizer, StreamingRecognizer, microphone_chunks)
from asr_dfcnn_transformer_torch.models import (TransformerLM,
                                                TransformerLMConfig)
from tests import test_streaming as jax_streaming
from tests._torch_cpu import use_two_threads

use_two_threads()

NFILT = 40
VOCAB = 32


class TinyConvCTC(nn.Module):
    """tests/test_streaming.py's TinyConvCTC in torch: 3 x (conv3x3 SAME +
    ReLU + maxpool 2), then a Dense head over F-major, C-minor rows; the
    Flax names, so convert.py bridges its variables."""

    def __init__(self, vocab_size: int = VOCAB, nfilt: int = NFILT):
        super().__init__()
        self.config = SimpleNamespace(vocab_size=vocab_size)
        chans = (1, 4, 4, 8)
        for i in range(3):
            self.add_module(f"Conv_{i}", nn.Conv2d(chans[i], chans[i + 1], 3,
                                                   padding=1))
        self.Dense_0 = nn.Linear((nfilt // 8) * chans[-1], vocab_size)

    def forward(self, x):                       # [B, 1, T, F]
        for i in range(3):
            x = nn.functional.max_pool2d(
                torch.relu(getattr(self, f"Conv_{i}")(x)), 2)
        b, c, t, f = x.shape
        return self.Dense_0(x.permute(0, 2, 3, 1).reshape(b, t, f * c))


def _port_pipeline(decode="greedy", with_lm=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    am = TinyConvCTC()
    for p in am.parameters():
        p.data = 0.3 * torch.randn(p.shape, generator=gen)
    lm = None
    if with_lm:
        lm = TransformerLM(TransformerLMConfig(
            VOCAB, 48, d_model=16, num_heads=4, num_blocks=1,
            position_max_length=24, dropout_rate=0.0, dtype=torch.float32),
            device="cpu", generator=gen)
    return Pipeline(am, lm, acoustic_vocab=vocab.acoustic_vocab(),
                    language_vocab=vocab.language_vocab() if with_lm
                    else None, feature_dim=NFILT, decode=decode)


def _to_flax(model):
    """The port model's weights as Flax variables (convert.py's inverse
    bridge, which tests/test_torch_models.py holds to the forward one; the
    "lm" kind takes a model without batch statistics)."""
    return jax.tree.map(jnp.asarray,
                        state_dict_to_flax(model.state_dict(), "lm"))


def _pair(with_lm=False, seed=0, decode="greedy"):
    """(JAX Pipeline, port Pipeline) on the same weights: tests/
    test_streaming.py's models, their variables bridged from the port's."""
    pipe = _port_pipeline(decode=decode, with_lm=with_lm, seed=seed)
    jlm = jlm_vars = None
    if with_lm:
        jlm = JaxTransformerLM(input_vocab_size=VOCAB, output_vocab_size=48,
                               d_model=16, num_heads=4, num_blocks=1,
                               position_max_length=24, dropout_rate=0.0,
                               dtype=jnp.float32)
        jlm_vars = _to_flax(pipe.lm_model)
    jpipe = JaxPipeline(jax_streaming.TinyConvCTC(vocab_size=VOCAB),
                        _to_flax(pipe.am_model), jlm, jlm_vars,
                        acoustic_vocab=jax_vocab.acoustic_vocab(),
                        language_vocab=jax_vocab.language_vocab()
                        if with_lm else None, feature_dim=NFILT,
                        decode=decode)
    return jpipe, pipe


_signal = jax_streaming._signal


def _global_stats(signal, nfilt=NFILT):
    """(mean', std) with which single centring reproduces the offline
    double-centred CMVN (tests/test_streaming.py's rule), from the port's
    log-mel."""
    raw = logfbank(torch.from_numpy(signal),
                   FbankConfig(nfilt=nfilt)).double().numpy()
    mean, std = raw.mean(axis=0), raw.std(axis=0)
    std = np.where(std == 0.0, 1.0, std)
    mean2 = ((raw - mean) / std).mean(axis=0)
    return (mean + std * mean2).astype(np.float32), std.astype(np.float32)


def _stream(rec, sig, rng=None, lo=137, hi=5003, step=None):
    i = 0
    while i < len(sig):
        n = step if step is not None else int(rng.integers(lo, hi))
        rec.push(sig[i: i + n])
        i += n
    return rec.finalize()


KW = dict(chunk_logits=8, halo_frames=64, frame_group=64)


# ---- port against JAX --------------------------------------------------

@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_incremental_matches_jax(decode):
    """The same pushes through JAX's and the port's recognizers on bridged
    weights, with the same global statistics: the same pinyin, partials
    and finals (and the same hanzi through a one-block LM)."""
    jpipe, pipe = _pair(with_lm=True, decode=decode, seed=2)
    sig = _signal(seconds=2.3, seed=13)
    stats = jax_streaming._exact_global_stats(sig, NFILT)
    jrec = JaxIncrementalRecognizer(jpipe, cmvn="global", global_stats=stats,
                                    **KW)
    rec = IncrementalRecognizer(pipe, cmvn="global", global_stats=stats,
                                **KW)
    rng = np.random.default_rng(23)
    i = 0
    while i < len(sig):
        n = int(rng.integers(211, 9001))
        jrec.push(sig[i: i + n])
        rec.push(sig[i: i + n])
        assert rec.partial() == jrec.partial()
        i += n
    want = jrec.finalize()
    assert rec.finalize() == want
    assert len(want[0]) > 0 and want[1] != ""


def test_incremental_running_cmvn_matches_jax():
    """Running CMVN (the f64 host statistics) gives JAX's tokens."""
    jpipe, pipe = _pair(seed=4)
    sig = _signal(seconds=2.1, seed=5)
    jrec = JaxIncrementalRecognizer(jpipe, cmvn="running", **KW)
    rec = IncrementalRecognizer(pipe, cmvn="running", **KW)
    for i in range(0, len(sig), 7777):
        jrec.push(sig[i: i + 7777])
        rec.push(sig[i: i + 7777])
    assert rec.finalize() == jrec.finalize()
    assert rec.pinyin_ids == jrec.pinyin_ids


# ---- the port against its own offline decode ---------------------------

def test_streamed_features_equal_offline():
    """Pre-emphasis formed on the host as the kernel forms it: the
    streamed raw log-mel rows equal the offline ``logfbank`` bit for
    bit, at any push size."""
    pipe = _port_pipeline()
    sig = _signal(seconds=1.7, seed=9)
    want = logfbank(torch.from_numpy(sig), FbankConfig(nfilt=NFILT)).numpy()
    for step in (977, 4000, len(sig)):
        rec = IncrementalRecognizer(pipe, cmvn="none", **KW)
        for i in range(0, len(sig), step):
            rec.push(sig[i: i + step])
        rec._emit_frames(final=True)
        np.testing.assert_array_equal(rec._feats, want)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_incremental_equals_offline_with_global_stats(decode):
    pipe = _port_pipeline(decode=decode)
    sig = _signal(seconds=2.7, seed=3)
    rec = IncrementalRecognizer(pipe, cmvn="global",
                                global_stats=_global_stats(sig), **KW)
    assert rec.decode == decode          # inherited from the pipeline
    pinyin, _ = _stream(rec, sig, np.random.default_rng(11))
    assert pinyin == pipe.recognize_signal(sig)[0]
    assert len(pinyin) > 0


def test_incremental_chunk_size_invariance_running_cmvn():
    sig = _signal(seconds=2.1, seed=5)
    pipe = _port_pipeline()
    outs = []
    for size in (1600, 7777, len(sig)):
        rec = IncrementalRecognizer(pipe, cmvn="running", **KW)
        _stream(rec, sig, step=size)
        outs.append(rec.pinyin_ids)
    assert outs[0] == outs[1] == outs[2], outs


def test_incremental_partials_and_lm():
    sig = _signal(seconds=1.9, seed=7)
    pipe = _port_pipeline(with_lm=True)
    rec = IncrementalRecognizer(pipe, cmvn="running", **KW)
    partial_lens = []
    for i in range(0, len(sig), 6400):
        rec.push(sig[i: i + 6400])
        pinyin, hanzi = rec.partial()
        partial_lens.append(len(rec.pinyin_ids))
        assert isinstance(hanzi, str)
        assert (hanzi == "") == (len(pinyin) == 0)
    pinyin, hanzi = rec.finalize()
    assert partial_lens == sorted(partial_lens)
    assert len(rec.pinyin_ids) >= partial_lens[-1]
    assert len(pinyin) > 0 and hanzi != ""


def test_incremental_rejects_bad_config():
    pipe = _port_pipeline()
    with pytest.raises(ValueError, match="halo"):
        IncrementalRecognizer(pipe, halo_frames=30)
    with pytest.raises(ValueError, match="chunk_logits"):
        IncrementalRecognizer(pipe, chunk_logits=0)
    with pytest.raises(ValueError, match="cmvn"):
        IncrementalRecognizer(pipe, cmvn="nope")
    with pytest.raises(ValueError, match="global_stats"):
        IncrementalRecognizer(pipe, cmvn="global")
    with pytest.raises(ValueError, match="decode"):
        IncrementalRecognizer(pipe, decode="viterbi")


def test_incremental_exact_bucket_boundary_parity():
    """256 frames, exactly on the bucket grid: the offline decode has
    bucket // 8 = 32 rows, not frames // 8 + 1, and so must the stream."""
    pipe = _port_pipeline()
    n = 400 + 255 * 160
    sig = _signal(seconds=n / 16000.0, seed=17)
    assert len(sig) == n
    rec = IncrementalRecognizer(pipe, cmvn="global",
                                global_stats=_global_stats(sig), **KW)
    pinyin, _ = _stream(rec, sig, step=3001)
    assert rec._logits_done == 256 // 8
    assert pinyin == pipe.recognize_signal(sig)[0]


@pytest.mark.parametrize("seed,decode", [(21, "greedy"), (29, "greedy"),
                                         (31, "beam")])
def test_incremental_near_bucket_boundary_parity(seed, decode):
    """250 frames, bucket 256: the tail window must end at the bucket
    edge, where the offline program's conv SAME boundary lies."""
    pipe = _port_pipeline(decode=decode)
    n = 400 + 249 * 160
    sig = _signal(seconds=n / 16000.0, seed=seed)
    rec = IncrementalRecognizer(pipe, cmvn="global",
                                global_stats=_global_stats(sig), **KW)
    pinyin, _ = _stream(rec, sig, step=2777)
    assert pinyin == pipe.recognize_signal(sig)[0]


def test_incremental_random_geometry_sweep():
    """Random lengths, push sizes and chunk / group geometry all give the
    offline decode."""
    rng = np.random.default_rng(123)
    pipes = {"greedy": _port_pipeline(), "beam": _port_pipeline("beam")}
    for trial in range(8):
        frames = int(rng.integers(40, 300))
        n = 400 + (frames - 1) * 160
        sig = _signal(seconds=(n + 1) / 16000.0, seed=100 + trial)[:n]
        decode = "beam" if trial % 4 == 3 else "greedy"
        pipe = pipes[decode]
        rec = IncrementalRecognizer(
            pipe, chunk_logits=int(rng.choice([4, 8, 16])), halo_frames=64,
            frame_group=int(rng.choice([32, 64, 128])), cmvn="global",
            global_stats=_global_stats(sig))
        pinyin, _ = _stream(rec, sig, rng, 97, 6007)
        assert pinyin == pipe.recognize_signal(sig)[0], (trial, frames,
                                                         decode)


def test_incremental_max_logits_enforced_mid_stream():
    pipe = _port_pipeline()
    rec = IncrementalRecognizer(pipe, cmvn="running", max_logits=16, **KW)
    sig = _signal(seconds=4.0, seed=19)
    for i in range(0, len(sig), 4000):
        rec.push(sig[i: i + 4000])
        assert rec._logits_done <= 16
    rec.finalize()
    assert rec._logits_done <= 16
    assert len(rec.pinyin_ids) <= 16


def test_streaming_recognizer_ring_buffer():
    """The record-then-decode recognizer keeps the last max_seconds and
    decodes them as the offline pipeline does."""
    pipe = _port_pipeline()
    sig = _signal(seconds=1.5, seed=2)
    rec = StreamingRecognizer(pipe, max_seconds=1.0)
    assert rec.result() == ([], "")
    outs = list(rec.run_stream((sig[i: i + 4000]
                                for i in range(0, len(sig), 4000)),
                               decode_every=0.5))
    assert rec.buffered_seconds == 1.0
    assert outs[-1] == pipe.recognize_signal(sig[-16000:])
    assert len(outs) >= 3
    rec.reset()
    assert rec.buffered_seconds == 0.0


def test_microphone_source_needs_pyaudio():
    try:
        import pyaudio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="pyaudio"):
            next(microphone_chunks(0.1))
    else:
        pytest.skip("pyaudio is installed here")


@pytest.mark.slow
def test_se_streaming_token_agreement(tmp_path):
    """tests/test_streaming_se_drift.py on the port: a trained SE-DFCNN
    (500 steps on the synthetic corpus) streams 24 unseen utterances of
    several windows each with their own global statistics; the token
    agreement with the offline decode stays above 0.95."""
    from asr_dfcnn_transformer_torch.audio.wav import read_wav
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus)
    from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
    from asr_dfcnn_transformer_torch.ops.edit_distance import edit_distance
    from asr_dfcnn_transformer_torch.train import AMTrainer

    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(tmp_path / "corpus"), num_utts=96, num_classes=4,
        syllables_per_utt=(2, 4), tone_ms=250, seed=42)
    long_dir, long_wav, _, _ = make_synthetic_corpus(
        str(tmp_path / "long"), num_utts=24, num_classes=4,
        syllables_per_utt=(6, 10), tone_ms=300, seed=77, modes=("test",))
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    train_dl = DataLoader(load_manifests(data_dir, "train",
                                         corpora=("thchs",)),
                          av, lv, speech_root=wav_root, bucket_bounds=(128,))
    am = SEDFCNN(SEDFCNNConfig(av.size, stage_features=(12, 12, 24, 24, 24),
                               head_features=24, dropout_rate=0.0,
                               dtype=torch.float32), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    tr = AMTrainer(am, str(tmp_path / "work"), lr=1.5e-3)
    tr.restore_or_init()
    batches = list(train_dl.am_batches(8, shuffle=False))
    gen = torch.Generator().manual_seed(1)
    for step in range(500):
        tr.train_step(batches[step % len(batches)], gen)
    pipe = Pipeline(am, None, acoustic_vocab=av)

    man = load_manifests(long_dir, "test", corpora=("thchs",))
    push_rng = np.random.default_rng(5)
    n = exact = err = tot = 0
    for path in man.paths:
        sig, _ = read_wav(os.path.join(long_wav, path))
        off_pny, _ = pipe.recognize_signal(sig)
        rec = IncrementalRecognizer(pipe, chunk_logits=8, halo_frames=32,
                                    frame_group=64, cmvn="global",
                                    global_stats=_global_stats(sig, 200))
        st_pny, _ = _stream(rec, sig, push_rng, 900, 3200)
        n += 1
        exact += int(st_pny == off_pny)
        err += edit_distance(off_pny, st_pny)
        tot += max(len(off_pny), 1)
    agreement = 1.0 - err / max(tot, 1)
    assert n == 24 and tot > 100
    assert agreement > 0.95, (
        f"SE streamed-vs-offline token agreement {agreement:.4f} <= 0.95 "
        f"({exact}/{n} utterances exact)")
