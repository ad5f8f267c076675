"""The port's Keras ``.hdf5`` reader and writer (``infer/hdf5_import.py``)
against the JAX package's: the port reads what the JAX writer and the JAX
tests' fake Keras file hold, the JAX reader reads what the port writes, bit
for bit; ``KerasDFCNN`` after an ``.hdf5`` round trip gives the JAX
``KerasDFCNN``'s logits on the same file; the layout checks raise with the
JAX messages; and the port CLI's ``eval --am-hdf5`` prints the JAX CLI's
accuracy lines and writes its ``pred_log`` on the same files."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.infer import hdf5_import as jh
from asr_dfcnn_transformer_tpu.models import KerasDFCNN as JaxKerasDFCNN
from asr_dfcnn_transformer_torch.convert import am_state_dict
from asr_dfcnn_transformer_torch.infer import hdf5_import as th
from asr_dfcnn_transformer_torch.models import KerasDFCNN, KerasDFCNNConfig
from tests._torch_cpu import use_two_threads
from tests.test_hdf5_import import _write_fake_keras

use_two_threads()

ACC = re.compile(r"^\*\[Test Result\] .*accuracy ratio: .*$", re.M)


def _flat(tree, prefix=()):
    if not isinstance(tree, dict):
        return {prefix: tree}
    return {k2: v2 for k, v in tree.items()
            for k2, v2 in _flat(v, prefix + (k,)).items()}


def _assert_trees_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        a, b = np.asarray(fg[k]), np.asarray(fw[k])
        assert a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def _jax_variables(vocab=30, dense_units=24, feat=40, seed=0):
    """A JAX KerasDFCNN's variables with random BatchNorm statistics (the
    init's would hide a swapped gamma / moving_variance)."""
    model = JaxKerasDFCNN(vocab, dense_units=dense_units, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 16, feat, 1))))
    rng = np.random.default_rng(seed)
    for cell in v["batch_stats"].values():
        st = cell["BatchNorm_0"]
        st["mean"] = (0.2 * rng.standard_normal(st["mean"].shape)
                      ).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    return model, v


def test_port_reads_the_jax_writer(tmp_path):
    _, v = _jax_variables()
    path = str(tmp_path / "jax.hdf5")
    jh.save_keras_dfcnn_hdf5(path, v, vocab_size=30, dense_units=24)
    _assert_trees_equal(th.load_keras_dfcnn_hdf5(path, 30, dense_units=24),
                        v)


def test_port_reads_the_fake_keras_file(tmp_path):
    """The JAX tests' emulation of a Keras-saved cnn_ctc file."""
    path = str(tmp_path / "fake.hdf5")
    _write_fake_keras(path, vocab=30)
    got = th.load_keras_dfcnn_hdf5(path, 30)
    _assert_trees_equal(got, jh.load_keras_dfcnn_hdf5(path, 30))
    assert got["params"]["Dense_1"]["kernel"].shape == (128, 30)


def test_jax_reads_the_port_writer(tmp_path):
    """The port's writer on a port model's state_dict (through
    ``convert.state_dict_to_flax``): the JAX reader gets every array of
    that tree, bit for bit, and the same file's attributes."""
    import h5py

    from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
    am = KerasDFCNN(KerasDFCNNConfig(30, dense_units=24), feature_dim=40,
                    device="cpu", generator=torch.Generator().manual_seed(3))
    v = state_dict_to_flax(am.state_dict(), "am")
    port_path, jax_path = str(tmp_path / "port.hdf5"), str(tmp_path / "j.hdf5")
    th.save_keras_dfcnn_hdf5(port_path, v, vocab_size=30, dense_units=24)
    jh.save_keras_dfcnn_hdf5(jax_path, v, vocab_size=30, dense_units=24)
    _assert_trees_equal(jh.load_keras_dfcnn_hdf5(port_path, 30, 24), v)
    with h5py.File(port_path, "r") as a, h5py.File(jax_path, "r") as b:
        ma, mb = a["model_weights"], b["model_weights"]
        assert list(ma.attrs["layer_names"]) == list(mb.attrs["layer_names"])
        for name in mb:
            assert list(ma[name].attrs["weight_names"]) == \
                list(mb[name].attrs["weight_names"])


def test_keras_dfcnn_logits_after_round_trip_match_jax(tmp_path):
    """The fake Keras file through the port's reader into the port's
    f32 KerasDFCNN, out through the port's writer and in again: the logits
    equal the JAX KerasDFCNN's on the JAX reader's variables of the same
    file (atol 1e-4, as the SE-DFCNN is held)."""
    path = str(tmp_path / "fake.hdf5")
    _write_fake_keras(path, vocab=30)
    x = np.random.default_rng(1).standard_normal((2, 32, 40)).astype(
        np.float32)
    want = np.asarray(JaxKerasDFCNN(30, dtype=jnp.float32).apply(
        jax.tree.map(jnp.asarray, jh.load_keras_dfcnn_hdf5(path, 30)),
        jnp.asarray(x)[..., None]))
    from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
    am = KerasDFCNN(KerasDFCNNConfig(30, dtype=torch.float32),
                    feature_dim=40, device="cpu")
    am.load_state_dict(am_state_dict(th.load_keras_dfcnn_hdf5(path, 30)),
                       strict=True)
    again = str(tmp_path / "again.hdf5")
    th.save_keras_dfcnn_hdf5(again, state_dict_to_flax(am.state_dict(), "am"),
                             vocab_size=30)
    am2 = KerasDFCNN(KerasDFCNNConfig(30, dtype=torch.float32),
                     feature_dim=40, device="cpu",
                     generator=torch.Generator().manual_seed(9))
    am2.load_state_dict(am_state_dict(th.load_keras_dfcnn_hdf5(again, 30)),
                        strict=True)
    am2.eval()
    with torch.inference_mode():
        got = am2(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == want.shape == (2, 4, 30)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_layout_errors_match_jax(tmp_path):
    """The reader's checks and messages are the JAX reader's: the 10 / 10
    / 2 layer count, the vocabulary, the dense width; and the writer's."""
    path = str(tmp_path / "fake.hdf5")
    _write_fake_keras(path, vocab=30)
    for kw, msg in ((dict(vocab_size=999), "vocab 30 != expected 999"),
                    (dict(vocab_size=30, dense_units=64),
                     "dense width 128 != expected 64")):
        for mod in (th, jh):
            with pytest.raises(ValueError, match=msg):
                mod.load_keras_dfcnn_hdf5(path, **kw)
    import h5py
    with h5py.File(path, "a") as f:
        del f["model_weights"]["conv2d_9"]
        names = [n for n in f["model_weights"].attrs["layer_names"]
                 if n != b"conv2d_9"]
        f["model_weights"].attrs["layer_names"] = np.array(names)
    for mod in (th, jh):
        with pytest.raises(ValueError, match=re.escape(
                "unexpected cnn_ctc layout: 9 convs, 10 BNs, 2 denses "
                "(want 10/10/2)")):
            mod.load_keras_dfcnn_hdf5(path, 30)
    _, v = _jax_variables()
    for kw, msg in ((dict(vocab_size=31, dense_units=24), "vocab mismatch"),
                    (dict(vocab_size=30, dense_units=25),
                     "dense width mismatch")):
        with pytest.raises(ValueError, match=msg):
            th.save_keras_dfcnn_hdf5(str(tmp_path / "x.hdf5"), v, **kw)


def test_missing_h5py_raises_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        th.load_keras_dfcnn_hdf5(str(tmp_path / "any.hdf5"), 30)
    with pytest.raises(ImportError, match="h5py"):
        th.save_keras_dfcnn_hdf5(str(tmp_path / "any.hdf5"), {}, 30)


def test_cli_eval_am_hdf5_prints_the_jax_cli_lines(tmp_path, capsys):
    """A full-width KerasDFCNN's weights written by the JAX writer and a
    small LM's TF1 bundle written by the JAX exporter, evaluated by both
    CLIs (``eval --am-hdf5 --lm-tf-ckpt``, the synthetic corpus): the same
    accuracy lines and the same ``pred_log``."""
    from asr_dfcnn_transformer_tpu.core import vocab
    from asr_dfcnn_transformer_tpu.infer import tf_ckpt as jax_tf
    from asr_dfcnn_transformer_tpu.models import TransformerLM
    from asr_dfcnn_transformer_tpu.train import cli as jax_cli
    from asr_dfcnn_transformer_torch.train import cli
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()
    _, am_vars = _jax_variables(vocab=av.size, dense_units=128, feat=200,
                                seed=4)
    am_path = str(tmp_path / "model.hdf5")
    jh.save_keras_dfcnn_hdf5(am_path, am_vars, vocab_size=av.size)
    lm = TransformerLM(av.size, lv.size, d_model=32, num_heads=4,
                       num_blocks=1, dropout_rate=0.0, dtype=jnp.float32)
    lm_vars = jax.tree.map(np.asarray, lm.init(jax.random.PRNGKey(2),
                                               jnp.ones((1, 8), jnp.int32)))
    lm_bundle = str(tmp_path / "lm" / "lm.ckpt")
    jax_tf.write_tf_checkpoint(lm_bundle,
                               jax_tf.export_tf1_lm(lm_vars, num_blocks=1))
    args = ["--synthetic", "16", "--small", "--batch-size", "8",
            "--am-hdf5", am_path, "--lm-tf-ckpt", lm_bundle]
    jax_cli.main(["eval", "--workdir", str(tmp_path / "jax")] + args)
    want = ACC.findall(capsys.readouterr().out)
    cli.main(["eval", "--workdir", str(tmp_path / "port"), "--platform",
              "cpu"] + args)
    got = ACC.findall(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    # random weights decode none of the corpus (0.00% both), so the
    # pred_logs, with every decoded pinyin and hanzi, are held equal too
    with open(tmp_path / "jax" / "pred" / "pred_log", encoding="utf-8") as a, \
            open(tmp_path / "port" / "pred" / "pred_log",
                 encoding="utf-8") as b:
        assert a.read() == b.read()
    # --model bigru: a cnn_rnn_ctc file of the JAX writer (its hidden width
    # read from the file), evaluated by both CLIs the same way
    from asr_dfcnn_transformer_tpu.models import BiGRUCTC
    bigru = BiGRUCTC(av.size, hidden=24, keras_parity=True,
                     dtype=jnp.float32)
    gru_vars = jax.tree.map(np.asarray, bigru.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 8, 200), jnp.float32)))
    gru_path = str(tmp_path / "bigru.hdf5")
    jh.save_keras_bigru_hdf5(gru_path, gru_vars, av.size, hidden=24)
    args[args.index("--am-hdf5") + 1] = gru_path
    jax_cli.main(["eval", "--workdir", str(tmp_path / "jax_gru"),
                  "--model", "bigru"] + args)
    want = ACC.findall(capsys.readouterr().out)
    cli.main(["eval", "--workdir", str(tmp_path / "port_gru"), "--platform",
              "cpu", "--model", "bigru"] + args)
    got = ACC.findall(capsys.readouterr().out)
    assert len(want) == 2 and got == want
    with open(tmp_path / "jax_gru" / "pred" / "pred_log",
              encoding="utf-8") as a, \
            open(tmp_path / "port_gru" / "pred" / "pred_log",
                 encoding="utf-8") as b:
        assert a.read() == b.read()
