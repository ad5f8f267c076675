"""The port's Pipeline (greedy and beam) against the JAX Pipeline on
bridged weights, its BatchingServer against its own direct path, its own
constants and vocabularies against the JAX package's, its models' default
device, and its freedom from JAX."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.core import constants as jax_constants
from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.data import (DataLoader, load_manifests,
                                            make_synthetic_corpus)
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_torch.convert import am_state_dict, lm_state_dict
from asr_dfcnn_transformer_torch.core import constants, vocab
from asr_dfcnn_transformer_torch.infer import (BatchingServer, Pipeline,
                                               infer_bucket_frames)
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from tests._torch_cpu import use_two_threads

use_two_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """As tests/test_pipeline.py: a synthetic corpus, a small SE-DFCNN and a
    one-block LM at f32, in both packages on the same weights."""
    root = tmp_path_factory.mktemp("torchpipe")
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        str(root), num_utts=8, num_classes=4, syllables_per_utt=(2, 3),
        tone_ms=200, seed=2)
    av, lv = jax_vocab.acoustic_vocab(), jax_vocab.language_vocab()
    m = load_manifests(data_dir, "test", corpora=("thchs",))
    dl = DataLoader(m, av, lv, speech_root=wav_root, bucket_bounds=(128,))
    am_kw = dict(vocab_size=av.size, stage_features=(4, 4, 8, 8, 8),
                 se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0)
    lm_kw = dict(d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0)
    jam = JaxSEDFCNN(dtype=jnp.float32, **am_kw)
    am_vars = jax.jit(jam.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 128, 200, 1)))
    jlm = JaxLM(av.size, lv.size, dtype=jnp.float32, **lm_kw)
    lm_vars = jax.jit(jlm.init)(jax.random.PRNGKey(1),
                                jnp.zeros((1, 8), jnp.int32))
    jax_pipe = JaxPipeline(jam, am_vars, jlm, lm_vars, acoustic_vocab=av,
                           language_vocab=lv)

    am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **am_kw), device="cpu")
    am.load_state_dict(am_state_dict(jax.tree.map(np.asarray, am_vars)))
    lm = TransformerLM(TransformerLMConfig(av.size, lv.size,
                                           dtype=torch.float32, **lm_kw),
                       device="cpu")
    lm.load_state_dict(lm_state_dict(jax.tree.map(np.asarray, lm_vars)))
    pipe = Pipeline(am, lm, acoustic_vocab=vocab.acoustic_vocab(),
                    language_vocab=vocab.language_vocab())
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


@pytest.fixture(scope="module")
def beam_setup(setup):
    """Beam pipelines (W = K = 8) in both packages on the setup's weights."""
    jax_pipe, pipe, batch = setup
    jax_beam = JaxPipeline(jax_pipe.am_model, jax_pipe.am_variables,
                           jax_pipe.lm_model, jax_pipe.lm_variables,
                           acoustic_vocab=jax_pipe.av,
                           language_vocab=jax_pipe.lv, decode="beam")
    beam = Pipeline(pipe.am_model, pipe.lm_model, acoustic_vocab=pipe.av,
                    language_vocab=pipe.lv, decode="beam")
    return jax_beam, beam, batch


def test_beam_pipeline_matches_jax(beam_setup):
    jax_beam, beam, batch = beam_setup
    assert beam.beam_width == 8 and beam.lm_max_len == 100
    want = jax_beam.recognize_batch(batch.signals, batch.signal_lengths,
                                    batch.bucket_frames)
    got = beam.recognize_batch(batch.signals, batch.signal_lengths,
                               batch.bucket_frames)
    names = ("pinyin ids", "pinyin lengths", "hanzi ids")
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert got[1].max() > 0


def test_beam_recognize_signal_matches_jax(beam_setup):
    jax_beam, beam, batch = beam_setup
    for i in (0, 3):
        sig = batch.signals[i][: batch.signal_lengths[i]]
        assert beam.recognize_signal(sig) == jax_beam.recognize_signal(sig)


def test_beam_server_matches_direct_path(beam_setup):
    _, beam, batch = beam_setup
    signals = [np.asarray(batch.signals[i][: batch.signal_lengths[i]])
               for i in range(4)]
    with BatchingServer(beam, max_batch=4, max_wait_ms=30.0,
                        bucket_bounds=(128,)) as srv:
        got = [f.result(timeout=300) for f in [srv.submit(s)
                                               for s in signals]]
    for sig, out in zip(signals, got):
        assert out == beam.recognize_signal(sig, bucket_frames=128)
        assert isinstance(out[0], list) and isinstance(out[1], str)


def test_pipeline_rejects_unknown_decode(setup):
    _, pipe, _ = setup
    with pytest.raises(ValueError, match="greedy"):
        Pipeline(pipe.am_model, acoustic_vocab=pipe.av, decode="sample")


def test_vocab_and_constants_match_jax():
    """The port's own copies hold the JAX package's values, symbol for
    symbol."""
    for make, size in (("acoustic_vocab", 1536), ("language_vocab", 6345),
                       ("e2e_language_vocab", 6347)):
        port, ref = getattr(vocab, make)(), getattr(jax_vocab, make)()
        assert port.size == size
        assert port.symbols == ref.symbols and port.str2id == ref.str2id
    av = vocab.acoustic_vocab()
    assert av.to_str(av.size - 1) == constants.BLANK_SYMBOL
    with pytest.raises(ValueError, match="OOV"):
        av.to_id("not-a-syllable")
    for name in ("PAD", "SOS", "EOS", "IGNORE_ID", "BLANK_SYMBOL",
                 "FEATURE_MAX_LENGTH", "FEATURE_DIM", "TIME_REDUCTION",
                 "MAX_LABEL_LENGTH", "PAD_FLAG", "SOS_FLAG", "EOS_FLAG"):
        assert getattr(constants, name) == getattr(jax_constants, name), name
    # the lexicon's dict.txt, byte for byte and as loaded
    from asr_dfcnn_transformer_torch.core import lexicon
    from asr_dfcnn_transformer_tpu.core import lexicon as jax_lexicon
    with open(lexicon.LEXICON_PATH, "rb") as a, \
            open(jax_lexicon.LEXICON_PATH, "rb") as b:
        assert a.read() == b.read()
    assert lexicon.LEXICON_PATH != jax_lexicon.LEXICON_PATH
    assert lexicon.load_lexicon() == jax_lexicon.load_lexicon()


def test_models_build_on_cuda_by_default(monkeypatch):
    """With no device given the models build on cuda, so without CUDA they
    raise rather than land on the CPU; device="cpu" builds there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    am_cfg = SEDFCNNConfig(8, stage_features=(2, 2, 2, 2, 2),
                           head_features=2)
    lm_cfg = TransformerLMConfig(8, 8, d_model=8, num_heads=2, num_blocks=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SEDFCNN(am_cfg, feature_dim=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(lm_cfg)
    for m in (SEDFCNN(am_cfg, feature_dim=16, device="cpu"),
              TransformerLM(lm_cfg, device="cpu")):
        assert {p.device.type for p in m.parameters()} == {"cpu"}


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises instead of running anything else."""
    from asr_dfcnn_transformer_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_every_c_entry_point_has_its_signature():
    """Each ``asr_*`` function of ``csrc/*.cu`` is bound with the argument
    and result types it declares: an unbound pointer argument would go
    through ctypes as a 32-bit int and be cut."""
    import ctypes
    import re

    from asr_dfcnn_transformer_torch.kernels import _build
    ctype = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong, "const char*": ctypes.c_char_p}
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for ret, name, params in re.findall(
                r"^(int|long long|const char\*) (asr_\w+)\(([^)]*)\)",
                src.read_text(), re.M):
            args = [p.strip() for p in params.split(",") if p.strip()]
            kinds = tuple(ctypes.c_void_p if "*" in a
                          else ctype[a.rsplit(" ", 1)[0]] for a in args)
            found[name] = (kinds, ctype[ret])
    assert len(found) >= 12
    assert found == _build._SIGNATURES


def test_package_never_imports_jax():
    """Importing every module of the port leaves jax, flax, h5py,
    matplotlib and tensorboard (which the card's machine lacks) and every
    module of the JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import asr_dfcnn_transformer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = ['ops.ctc', 'ops.edit_distance', 'kernels.ctc',\n"
        "        'kernels.topk', 'kernels.beam', 'core.vocab',\n"
        "        'train.trainer', 'train.checkpoint', 'train.schedule',\n"
        "        'data.batches', 'kernels.dual_attention', 'audio.lfr',\n"
        "        'models.speech_transformer', 'infer.e2e_serving',\n"
        "        'audio.specaugment', 'kernels.ffn', 'core.config',\n"
        "        'train.factory', 'ops.matfft', 'kernels.fft_epilogue',\n"
        "        'audio.noise', 'audio.wav', 'audio.noise_corpus',\n"
        "        'data.manifest', 'data.synthetic', 'data.loader',\n"
        "        'train.identity', 'train.cli', 'infer.tf_ckpt',\n"
        "        'infer.hdf5_import', 'gates', 'models.bigru',\n"
        "        'models.ctc_attention', 'models.am_lm_joint',\n"
        "        'core.lexicon', 'utils.phoneme', 'utils.plotting',\n"
        "        'utils.tb_events', 'utils.introspect', 'parallel.mesh',\n"
        "        'parallel.tensor', 'parallel.dryrun',\n"
        "        'data.native_loader']\n"
        "missing = [n for n in need if p.__name__ + '.' + n"
        " not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',"
        " 'h5py', 'matplotlib', 'tensorboard')"
        " or m.startswith('asr_dfcnn_transformer_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
