"""``E2EServing`` (the port's e2e server) against the JAX package's serving
program on weights bridged by convert.py: bucketing, padding and chunking,
greedy and beam (the JAX program's ``greedy_decode_cached`` /
``beam_decode_cached`` run eagerly). Split from tests/test_torch_e2e.py,
whose model helpers it shares."""

import numpy as np
import pytest

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.audio.fbank import FbankConfig as JaxFbankCfg
from asr_dfcnn_transformer_tpu.audio.fbank import (
    batched_fbank as jax_batched_fbank,
)
from asr_dfcnn_transformer_tpu.audio.lfr import (
    batched_lfr as jax_batched_lfr,
)
from asr_dfcnn_transformer_tpu.infer.export_serving import (
    E2EServing as JaxE2EServing,
)
from asr_dfcnn_transformer_tpu.infer.export_serving import _ArtifactBase
from asr_dfcnn_transformer_torch.core import vocab as port_vocab
from asr_dfcnn_transformer_torch.infer import E2EServing
from tests._torch_cpu import use_two_threads
from tests.test_torch_e2e import MAX_LEN, _jax_model, _port, _variables

use_two_threads()

NFILT = 8
SERVE_FD = 4 * NFILT          # LFR m 4
BUCKETS = (16, 32)


class _JaxServing(JaxE2EServing):
    """The JAX package's E2EServing with each (batch, bucket) program run
    eagerly (export_e2e's fn_for_bucket) instead of from an artifact."""

    def __init__(self, model, variables, decode, batch_sizes):
        _ArtifactBase.__init__(self, {"win_len": 400, "hop": 160},
                               {(b, f): None for b in batch_sizes
                                for f in BUCKETS}, ())
        self._prog = (model, variables, decode)

    def _call(self, batch, bucket):
        model, v, decode = self._prog

        def fn(signals, lengths):
            feats, valid = jax_batched_fbank(
                signals, lengths, cfg=JaxFbankCfg(nfilt=NFILT),
                out_frames=bucket)
            lfr, lfr_valid = jax_batched_lfr(feats, valid, 4, 3)
            if decode == "beam":
                ids, lens, _ = jm.beam_decode_cached(
                    model, v, lfr[..., None], lfr_valid, beam_size=3,
                    lp_alpha=0.6, max_len=MAX_LEN)
                return ids, lens
            return jm.greedy_decode_cached(model, v, lfr[..., None],
                                           lfr_valid, max_len=MAX_LEN)
        return fn


def _serving(decode, batch_sizes):
    v = _variables(False, fd=SERVE_FD)
    vocab = port_vocab.build_vocab(["<pad>", "<sos>", "</sos>"]
                                   + [chr(0x4e00 + i) for i in range(47)])
    srv = E2EServing(_port(v, fd=SERVE_FD), vocab, feature_dim=NFILT,
                     decode=decode, max_len=MAX_LEN, batch_sizes=batch_sizes,
                     buckets=BUCKETS)
    return srv, _JaxServing(_jax_model("einsum"), v, decode, batch_sizes)


def _signals(lengths, seed=7):
    rng = np.random.default_rng(seed)
    signals = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        signals[i, :n] = 0.3 * rng.standard_normal(n)
    return signals, np.asarray(lengths, np.int32)


def test_serving_matches_jax_program():
    """Three utterances at batch size 2: a chunk whose 42-frame signal is
    truncated to the last bucket (32), then one utterance zero-padded to
    batch 2; ids and lengths equal the JAX serving program's."""
    srv, jax_srv = _serving("greedy", (2,))
    signals, lengths = _signals([1200, 7000, 5000])
    want = jax_srv.recognize_batch(signals, lengths)
    got = srv.recognize_batch(signals, lengths)
    assert len(srv.chunk_ms) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape[0] == 3
        np.testing.assert_array_equal(g, np.asarray(w))
    text = srv.recognize_signal(signals[2, :lengths[2]])
    assert text == "".join(srv.language_vocab.decode(
        got[0][2][:int(got[1][2])]))
    assert srv._pick_bucket(16) == 16 and srv._pick_bucket(17) == 32
    assert srv._pick_bucket(99) == 32


def test_serving_beam_matches_jax_program():
    srv, jax_srv = _serving("beam", (2,))
    signals, lengths = _signals([1200, 5000])
    want = jax_srv.recognize_batch(signals, lengths)
    got = srv.recognize_batch(signals, lengths)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_serving_rejects_unknown_decode():
    v = _variables(False, fd=SERVE_FD)
    with pytest.raises(ValueError, match="decode"):
        E2EServing(_port(v, fd=SERVE_FD), port_vocab.build_vocab(["a"]),
                   decode="sample")
