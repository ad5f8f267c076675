"""The port's checkpoint identity stamps (``train/identity.py``) against the
JAX package's: the same stamp, parsed and as file bytes, for every model
the CLIs build; structural mismatches raise, advisory ones warn, the
override passes; the trainers check a stamp before a restore and stamp an
unstamped checkpoint on its first restore; each package checks the other's
stamp files."""

import argparse
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.train import cli as jax_cli
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_torch.core import vocab
from asr_dfcnn_transformer_torch.core.config import Config
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                SpeechTransformer,
                                                TransformerLM,
                                                TransformerLMConfig)
from asr_dfcnn_transformer_torch.train import AMTrainer, factory
from asr_dfcnn_transformer_torch.train import cli as port_cli
from asr_dfcnn_transformer_torch.train import identity
from asr_dfcnn_transformer_torch.train.identity import ModelIdentityError
from tests._torch_cpu import use_two_threads

use_two_threads()

AV, LV, EV = (vocab.acoustic_vocab().size, vocab.language_vocab().size,
              vocab.e2e_language_vocab().size)
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float32": (jnp.float32, torch.float32)}


def _cli_args(small: bool, cfg: Config) -> argparse.Namespace:
    return argparse.Namespace(small=small, device=torch.device("meta"),
                              cfg=cfg, seed=0)


def _same_stamp(tmp_path, port_model, jax_model):
    """Both stamps, parsed and as the bytes of their identity files."""
    assert identity.model_identity(port_model) == \
        jax_identity.model_identity(jax_model)
    a, b = tmp_path / "port", tmp_path / "jax"
    identity.write_identity(str(a), port_model)
    jax_identity.write_identity(str(b), jax_model)
    assert (a / "identity.json").read_bytes() == \
        (b / "identity.json").read_bytes()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["se_dfcnn", "se_dfcnn_pre",
                                  "se_dfcnn_fast"])
def test_am_stamp_equals_jax(tmp_path, name, dtype):
    """Full width through both factories and both CLIs' model functions."""
    jdt, _ = DTYPES[dtype]
    cfg = Config().replace(am=dataclasses.replace(Config().am, model=name,
                                                  dtype=dtype))
    port = factory.build_am_model(cfg, device="meta")
    ref = jax_cli._am_model(name, AV, small=False, dtype=jdt)
    _same_stamp(tmp_path, port, ref)
    port_cli_model = port_cli._am_model(_cli_args(False, cfg), name, AV)
    assert identity.model_identity(port_cli_model) == \
        identity.model_identity(port)
    if name == "se_dfcnn_fast":
        assert jax_identity.model_identity(ref) == \
            jax_identity.model_identity(jm.SEDFCNN.fast(AV, dtype=jdt))


@pytest.mark.parametrize("name", ["se_dfcnn", "se_dfcnn_pre",
                                  "se_dfcnn_fast"])
def test_small_am_stamp_equals_jax(tmp_path, name):
    port = port_cli._am_model(_cli_args(True, Config()), name, AV)
    _same_stamp(tmp_path, port, jax_cli._am_model(name, AV, small=True))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("small", [False, True])
def test_lm_stamp_equals_jax(tmp_path, small, dtype):
    jdt, tdt = DTYPES[dtype]
    if small:
        port = port_cli._lm_model(_cli_args(True, Config()), AV, LV)
        port = TransformerLM(dataclasses.replace(port.config, dtype=tdt),
                             device="meta")
        ref = jax_cli._lm_model(AV, LV, small=True).clone(dtype=jdt)
    else:
        cfg = Config().replace(lm=dataclasses.replace(Config().lm,
                                                      dtype=dtype))
        port = port_cli._lm_model(_cli_args(False, cfg), AV, LV)
        ref = jm.TransformerLM(AV, LV, dtype=jdt)
        if dtype == "bfloat16":
            assert jax_identity.model_identity(ref) == \
                jax_identity.model_identity(jax_cli._lm_model(AV, LV, False))
    _same_stamp(tmp_path, port, ref)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("small", [False, True])
def test_e2e_stamp_equals_jax(tmp_path, small, dtype):
    jdt, tdt = DTYPES[dtype]
    if small:
        port, nfilt = port_cli._e2e_model(_cli_args(True, Config()), EV)
        assert nfilt == 40
        port = SpeechTransformer(dataclasses.replace(port.config, dtype=tdt),
                                 feature_dim=160, device="meta")
        ref = jm.SpeechTransformer(EV, d_model=32, num_heads=4,
                                   num_enc_blocks=1, num_dec_blocks=1,
                                   prenet_channels=8, dropout_rate=0.0,
                                   dtype=jdt)
    else:
        cfg = Config().replace(e2e=dataclasses.replace(Config().e2e,
                                                       dtype=dtype))
        port, nfilt = port_cli._e2e_model(_cli_args(False, cfg), EV)
        assert nfilt == 80
        ref = jm.SpeechTransformer(EV, dtype=jdt)
    _same_stamp(tmp_path, port, ref)


def _small_am(**kw):
    base = dict(stage_features=(4, 4, 8, 8, 8), head_features=8,
                dropout_rate=0.0, dtype=torch.float32)
    base.update(kw)
    return SEDFCNN(SEDFCNNConfig(40, **base), feature_dim=16, device="cpu")


def test_diff_classifies_structural_vs_advisory(tmp_path, capsys):
    d = str(tmp_path)
    identity.write_identity(d, _small_am())
    identity.check_identity(d, _small_am())           # same: silent
    assert capsys.readouterr().err == ""
    with pytest.raises(ModelIdentityError, match="se_first"):
        identity.check_identity(d, _small_am(se_first=True))
    with pytest.raises(ModelIdentityError, match="head_features"):
        identity.check_identity(d, _small_am(head_features=16))
    identity.check_identity(d, _small_am(dtype=torch.bfloat16,
                                         dropout_rate=0.3))
    err = capsys.readouterr().err
    assert "advisory" in err and "dtype" in err and "dropout_rate" in err
    identity.check_identity(d, _small_am(se_first=True), override=True)
    assert "STRUCTURAL mismatch overridden" in capsys.readouterr().err
    diff = identity.diff_identity(identity.read_identity(d),
                                  _small_am(se_first=True,
                                            dtype=torch.bfloat16))
    assert set(diff["structural"]) == {"se_first"}
    assert set(diff["advisory"]) == {"dtype"}


def test_advisory_fused_ffn_and_class_mismatch(tmp_path, capsys):
    d = str(tmp_path)
    cfg = TransformerLMConfig(12, 14, d_model=16, num_heads=2, num_blocks=1,
                              dtype=torch.float32)
    identity.write_identity(d, TransformerLM(cfg, device="cpu"))
    identity.check_identity(d, TransformerLM(
        dataclasses.replace(cfg, fused_ffn="pallas"), device="cpu"))
    assert "fused_ffn: 'auto' -> 'pallas'" in capsys.readouterr().err
    with pytest.raises(ModelIdentityError, match="class"):
        identity.check_identity(d, _small_am())
    assert identity.check_identity(str(tmp_path / "none"), _small_am()) \
        is None                                       # no stamp: passes


FRAMES = 64
N_SAMPLES = (FRAMES - 1) * 160 + 400


def _am_batch(batch=2):
    rng = np.random.default_rng(0)
    sig = (0.1 * rng.standard_normal((batch, N_SAMPLES))).astype(np.float32)
    lab = np.concatenate([rng.integers(3, 30, (batch, 4)),
                          np.zeros((batch, 4))], 1).astype(np.int32)
    n = np.full((batch,), 4, np.int32)
    return AMBatch(sig, np.full((batch,), N_SAMPLES, np.int32),
                   np.full((batch,), FRAMES, np.int32), lab, n, lab, n,
                   np.ones((batch,), np.float32), FRAMES)


def _trainer(workdir, **kw):
    model = SEDFCNN(SEDFCNNConfig(40, stage_features=(4, 4, 8, 8, 8),
                                  head_features=8, dropout_rate=0.0,
                                  dtype=torch.float32, **kw),
                    feature_dim=200, device="cpu")
    return AMTrainer(model, workdir)


def test_trainer_refuses_mismatched_checkpoint(tmp_path):
    wd = str(tmp_path)
    tr = _trainer(wd)
    assert tr.restore_or_init() == 0                  # fresh: stamped
    stamp = identity.read_identity(tr.ckpt.directory)
    assert stamp == identity.model_identity(tr.model)
    tr.train_step(_am_batch())
    tr.save(0)
    other = _trainer(wd, se_first=True)
    with pytest.raises(ModelIdentityError, match="se_first"):
        other.restore_or_init()
    other.allow_model_mismatch = True
    assert other.restore_or_init() == 1               # overridden
    again = _trainer(wd)
    assert again.restore_or_init() == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k


def test_unstamped_checkpoint_is_stamped_on_first_restore(tmp_path, capsys):
    wd = str(tmp_path)
    tr = _trainer(wd)
    tr.train_step(_am_batch())
    tr.save(0)                                        # no restore: unstamped
    assert identity.read_identity(tr.ckpt.directory) is None
    capsys.readouterr()
    again = _trainer(wd, se_first=True)
    assert again.restore_or_init() == 1               # trusted, then stamped
    assert "stamping the unstamped checkpoint" in capsys.readouterr().err
    assert identity.read_identity(tr.ckpt.directory) == \
        identity.model_identity(again.model)
    with pytest.raises(ModelIdentityError, match="se_first"):
        _trainer(wd).restore_or_init()


def test_each_package_checks_the_others_stamp(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_identity.write_identity(jax_dir, jax_cli._am_model("se_dfcnn", AV,
                                                           small=True))
    args = _cli_args(True, Config())
    identity.check_identity(jax_dir, port_cli._am_model(args, "se_dfcnn",
                                                        AV))
    with pytest.raises(ModelIdentityError, match="se_first"):
        identity.check_identity(jax_dir, port_cli._am_model(
            args, "se_dfcnn_pre", AV))
    identity.write_identity(port_dir, port_cli._am_model(args, "se_dfcnn_pre",
                                                         AV))
    jax_identity.check_identity(port_dir, jax_cli._am_model(
        "se_dfcnn_pre", AV, small=True))
    with pytest.raises(jax_identity.ModelIdentityError, match="se_first"):
        jax_identity.check_identity(port_dir, jax_cli._am_model(
            "se_dfcnn", AV, small=True))
    assert os.path.basename(identity.identity_path(port_dir)) == \
        jax_identity.IDENTITY_FILE
    assert identity.ADVISORY_FIELDS == jax_identity.ADVISORY_FIELDS
