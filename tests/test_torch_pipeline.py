"""The port's Pipeline against the JAX Pipeline on bridged weights, its
BatchingServer against its own direct path, and its freedom from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.core import vocab
from asr_dfcnn_transformer_tpu.data import (DataLoader, load_manifests,
                                            make_synthetic_corpus)
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_torch.convert import am_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.infer import (BatchingServer, Pipeline,
                                               infer_bucket_frames)
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """As tests/test_pipeline.py: a synthetic corpus, a small SE-DFCNN and a
    one-block LM at f32, in both packages on the same weights."""
    root = tmp_path_factory.mktemp("torchpipe")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=2)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    m = load_manifests(data_dir, "test", corpora=("thchs",))
    dl = DataLoader(m, av, lv, speech_root=wav_root, bucket_bounds=(128,))
    am_kw = dict(vocab_size=av.size, stage_features=(4, 4, 8, 8, 8),
                 se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0)
    lm_kw = dict(d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0)
    jam = JaxSEDFCNN(dtype=jnp.float32, **am_kw)
    am_vars = jam.init(jax.random.PRNGKey(0), jnp.zeros((1, 128, 200, 1)))
    jlm = JaxLM(av.size, lv.size, dtype=jnp.float32, **lm_kw)
    lm_vars = jlm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))
    jax_pipe = JaxPipeline(jam, am_vars, jlm, lm_vars, acoustic_vocab=av,
                           language_vocab=lv)

    am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **am_kw))
    am.load_state_dict(am_state_dict(jax.tree.map(np.asarray, am_vars)))
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size,
                                           dtype=torch.float32, **lm_kw))
    lm.load_state_dict(lm_state_dict(jax.tree.map(np.asarray, lm_vars)))
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv)
    batch = next(dl.am_batches(8, shuffle=False))
    return jax_pipe, pipe, batch


def test_pipeline_matches_jax(setup):
    jax_pipe, pipe, batch = setup
    want = jax_pipe.recognize_batch(batch.signals, batch.signal_lengths,
                                    batch.bucket_frames)
    got = pipe.recognize_batch(batch.signals, batch.signal_lengths,
                               batch.bucket_frames)
    names = ("pinyin ids", "pinyin lengths", "hanzi ids")
    for g, w, name in zip(got, want, names):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[0].shape[1] == 100      # decoded up to the LM's positions
    assert got[1].max() > 0            # a non-trivial decode was compared


def test_recognize_signal_matches_jax(setup):
    jax_pipe, pipe, batch = setup
    sig = batch.signals[0][: batch.signal_lengths[0]]
    assert pipe.recognize_signal(sig) == jax_pipe.recognize_signal(sig)
    assert infer_bucket_frames(1) == 128
    assert infer_bucket_frames(129) == 256
    assert infer_bucket_frames(10 ** 6) == 1600


def test_server_matches_direct_path(setup):
    _, pipe, batch = setup
    signals = [np.asarray(batch.signals[i][: batch.signal_lengths[i]])
               for i in range(8) if batch.weights[i] > 0]
    with BatchingServer(pipe, max_batch=4, max_wait_ms=30.0,
                        bucket_bounds=(128,)) as srv:
        futures = [srv.submit(s) for s in signals]
        got = [f.result(timeout=300) for f in futures]
    for sig, (pinyin, hanzi) in zip(signals, got):
        assert isinstance(pinyin, list) and isinstance(hanzi, str)
        assert (pinyin, hanzi) == pipe.recognize_signal(sig, bucket_frames=128)
    assert srv.stats.batches < len(signals)      # coalescing happened
    assert srv.stats.requests == len(signals)
    with pytest.raises(RuntimeError):
        srv.submit(signals[0])


def test_server_bucket_selection(setup):
    _, pipe, _ = setup
    with BatchingServer(pipe, bucket_bounds=(128, 256)) as srv:
        assert srv._bucket_of(400) == 128
        assert srv._bucket_of(128 * 160 + 240) == 128
        assert srv._bucket_of(130 * 160) == 256
        assert srv._bucket_of(10 ** 9) == 256


def test_pipeline_rejects_beam(setup):
    _, pipe, _ = setup
    with pytest.raises(ValueError, match="greedy"):
        Pipeline(pipe.am_model, acoustic_vocab=pipe.av, decode="beam")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of running anything else."""
    from asr_dfcnn_transformer_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_package_never_imports_jax():
    """Importing every module of the port leaves jax and flax out of
    sys.modules, and of the JAX package only core is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import asr_dfcnn_transformer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['ops.ctc', 'ops.edit_distance', 'kernels.ctc',\n"
        "        'train.trainer', 'train.checkpoint', 'train.schedule',\n"
        "        'data.batches']\n"
        "missing = [n for n in need if p.__name__ + '.' + n"
        " not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax')"
        " or (m.startswith('asr_dfcnn_transformer_tpu.')"
        " and not m.startswith('asr_dfcnn_transformer_tpu.core'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
