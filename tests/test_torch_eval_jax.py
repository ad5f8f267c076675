"""``Pipeline.from_checkpoints`` over a JAX checkpoint converted by
``convert.flax_checkpoint_to_port`` (split from tests/test_torch_eval.py,
whose corpus and models it shares)."""

import jax
import numpy as np
import pytest

from asr_dfcnn_transformer_tpu.core import vocab as jax_vocab
from asr_dfcnn_transformer_tpu.infer import Pipeline as JaxPipeline
from asr_dfcnn_transformer_tpu.parallel import make_mesh
from asr_dfcnn_transformer_tpu.train import AMTrainer as JaxAMTrainer
from asr_dfcnn_transformer_tpu.train import LMTrainer as JaxLMTrainer
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from asr_dfcnn_transformer_torch.convert import flax_checkpoint_to_port
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.infer import Pipeline
from asr_dfcnn_transformer_torch.train import identity
from tests._torch_cpu import use_two_threads
from tests.test_torch_eval import (_jax_models, _loaders,  # noqa: F401
                                   _port_models, corpus)

use_two_threads()


def test_jax_checkpoint_end_to_end(tmp_path, corpus):
    """A JAX AM and LM take one small training step each and save through
    orbax; their raw trees become port checkpoints; the port's
    ``Pipeline.from_checkpoints`` then gives the JAX one's ids exactly,
    and refuses a model of another architecture."""
    jl, pl = _loaders(corpus, "train")
    jam, jlm = _jax_models()
    mesh = make_mesh(1, 1, jax.devices()[:1])
    jax_wd, port_wd = str(tmp_path / "jax"), str(tmp_path / "port")
    am_batch = next(jl.am_batches(8, shuffle=False))
    lm_batch = next(jl.lm_batches(8, shuffle=False))
    for tr, batches, key in (
            (JaxAMTrainer(jam, jax_wd, lr=1e-3, mesh=mesh),
             lambda: iter([am_batch]), 0),
            (JaxLMTrainer(jlm, jax_wd, lr=1e-3, mesh=mesh),
             lambda: iter([lm_batch]), 1)):
        tr.restore_or_init(lambda: tr.init_state(jax.random.PRNGKey(key),
                                                 batches().__next__()))
        tr.fit(batches, batches, epochs=1, rng=jax.random.PRNGKey(key))
    for name in ("am", "lm"):
        src = f"{jax_wd}/ckpt_{name}"
        flax_checkpoint_to_port(JaxCheckpointManager(src).restore_raw_best(),
                                jax_identity.read_identity(src),
                                f"{port_wd}/ckpt_{name}")
        with open(f"{src}/identity.json", "rb") as a, \
                open(f"{port_wd}/ckpt_{name}/identity.json", "rb") as b:
            assert a.read() == b.read()
    want = JaxPipeline.from_checkpoints(
        jax_wd, jam, jlm, acoustic_vocab=jax_vocab.acoustic_vocab(),
        language_vocab=jax_vocab.language_vocab())
    am, lm = _port_models()
    got = Pipeline.from_checkpoints(
        port_wd, am, lm, acoustic_vocab=vocab.acoustic_vocab(),
        language_vocab=vocab.language_vocab())
    batch = next(pl.am_batches(8, shuffle=False))
    w = want.recognize_batch(batch.signals, batch.signal_lengths,
                             batch.bucket_frames)
    g = got.recognize_batch(batch.signals, batch.signal_lengths,
                            batch.bucket_frames)
    for gi, wi, name in zip(g, w, ("pinyin ids", "lengths", "hanzi ids")):
        np.testing.assert_array_equal(gi, np.asarray(wi), err_msg=name)
    assert g[1].max() > 0
    wrong, _ = _port_models(se_first=True)
    with pytest.raises(identity.ModelIdentityError, match="se_first"):
        Pipeline.from_checkpoints(port_wd, wrong,
                                  acoustic_vocab=vocab.acoustic_vocab())
    Pipeline.from_checkpoints(port_wd, wrong, allow_model_mismatch=True,
                              acoustic_vocab=vocab.acoustic_vocab())
    with pytest.raises(FileNotFoundError, match="no AM checkpoint"):
        Pipeline.from_checkpoints(str(tmp_path / "none"), am,
                                  acoustic_vocab=vocab.acoustic_vocab())
